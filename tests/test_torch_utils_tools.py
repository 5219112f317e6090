"""The port's small user-facing utilities against the JAX package's:
the parameter table (``utils/summary.py``) and its use by the trainer,
``assert_shape``, the stdout tee ``Logger`` and local ``open_url``
(``utils/io.py``), and saving, loading and merging a config tree
(``utils/config.py``). Tiny networks, on the CPU."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aid_tpu.models.unet_cqt import UnetCQT as JaxUnet
from aid_tpu.ops.cqt import get_cqt as jax_get_cqt
from aid_tpu.utils import config as jconfig
from aid_tpu.utils import summary as jsummary
from aid_tpu_torch import setup as tsetup
from aid_tpu_torch.models import unet_cqt as tunet
from aid_tpu_torch.ops.cqt import get_cqt
from aid_tpu_torch.utils import config as tconfig
from aid_tpu_torch.utils import summary
from aid_tpu_torch.utils.convert import state_dict_from_flax
from aid_tpu_torch.utils.io import Logger, open_url
from tests.torch_threads import one_torch_thread  # noqa: F401

O, BINS, LEN, FS = 3, 8, 2048, 4096.0
NS, NUM_DILS, ATT_LAYERS, EMB = (8, 16, 16), (1, 2, 2), (0, 1, 1, 1), 32
ATTN = dict(num_heads=2, bias_qkv=False, use_rel_pos=True, rel_pos_num_buckets=32,
            rel_pos_max_distance=64)


def _total(table: str) -> int:
    line = next(l for l in table.splitlines() if l.startswith("TOTAL"))
    return int(re.sub(r"[^0-9]", "", line[5:]))


@pytest.mark.parametrize("use_fencoding", [False, True])
def test_param_table_total_matches_jax(use_fencoding):
    jnet = JaxUnet(cqt=jax_get_cqt(O, BINS, FS, LEN), Ns=NS, num_dils=NUM_DILS,
                   attention_layers=ATT_LAYERS, attention=ATTN, emb_dim=EMB,
                   use_fencoding=use_fencoding)
    params = jax.jit(jnet.init)(jax.random.PRNGKey(0), jnp.zeros((1, LEN)), jnp.zeros((1, 1)))
    net = tunet.UnetCQT(get_cqt(O, BINS, FS, LEN), NS, NUM_DILS, ATT_LAYERS, ATTN,
                        emb_dim=EMB, use_fencoding=use_fencoding)
    net.load_state_dict(state_dict_from_flax(params))
    table = summary.param_table(net)
    n = _total(jsummary.param_table(params))
    assert _total(table) == n == sum(p.numel() for p in net.parameters())
    # a row per top-level child, and a row per tensor (122 tensors <= 200)
    tops = {name.split(".")[0] for name, _ in net.named_parameters()}
    assert all(any(l.startswith(t + " ") for l in table.splitlines()) for t in tops)
    assert "embedding.RFF_freq" in summary.param_table(net, max_rows=200)
    assert "embedding.RFF_freq" not in summary.param_table(net, max_rows=3)
    # (name, shape) pairs, as a sharded trainer keeps them, give the same table
    shapes = [(k, tuple(p.shape)) for k, p in net.named_parameters()]
    assert summary.param_table(shapes) == table


def test_print_model_summary_returns_the_count(capsys):
    net = tunet.UnetCQT(get_cqt(O, BINS, FS, LEN), NS, NUM_DILS, ATT_LAYERS, ATTN, emb_dim=EMB)
    n = summary.print_model_summary(net)
    assert n == sum(p.numel() for p in net.parameters())
    assert _total(capsys.readouterr().out) == n


def test_trainer_prints_the_table_under_print_model_summary(tmp_path, capsys):
    ov = ["exp.audio_len=2048", "exp.batch=2", "network.cqt.num_octs=3",
          "network.cqt.bins_per_oct=8", "network.Ns=[8,16,16]", "network.num_dils=[1,1,1]",
          "network.attention_layers=[0,0,1,1]", "network.compute_dtype=float32",
          f"model_dir={tmp_path}"]
    for flag in (True, False):
        args = tconfig.compose(overrides=ov + [f"logging.print_model_summary={flag}"])
        net = tsetup.setup_network(args, device="cpu", trainable=True)
        tr = tsetup.setup_trainer(args, network=net,
                                  diff_params=tsetup.setup_diff_parameters(args))
        tr.init_state()
        out = capsys.readouterr().out
        assert ("TOTAL" in out) is flag
        if flag:
            assert _total(out) == sum(p.numel() for p in net.parameters())


@pytest.mark.parametrize("ref,ok", [((2, 3), True), ((None, 3), True), ((2, None), True),
                                    ((3, 3), False), ((2, 3, 1), False), ((2,), False)])
def test_assert_shape_as_jax(ref, ok):
    for mod, x in ((summary, torch.zeros(2, 3)), (jsummary, np.zeros((2, 3)))):
        if ok:
            mod.assert_shape(x, ref)
        else:
            with pytest.raises(AssertionError):
                mod.assert_shape(x, ref)


def test_io_logger_and_local_open_url(tmp_path):
    p = tmp_path / "log.txt"
    with Logger(str(p)) as lg:
        print("hello-tee")
        assert lg.file is not None
    assert "hello-tee" in p.read_text()
    f = tmp_path / "blob.bin"
    f.write_bytes(b"xyz")
    with open_url(str(f)) as fh:
        assert fh.read() == b"xyz"


def test_save_load_merge_config_as_jax(tmp_path):
    """The port's save_config writes what the JAX package's loads and the
    other way round, and merge_config gives the same tree."""
    args = tconfig.compose(overrides=["exp.lr=1e-4", "network.Ns=[8,16]"])
    tconfig.save_config(args, str(tmp_path / "port.yaml"))
    jconfig.save_config(jconfig.EasyDict(args.to_dict()), str(tmp_path / "jax.yaml"))
    assert (tmp_path / "port.yaml").read_text() == (tmp_path / "jax.yaml").read_text()
    back = tconfig.load_saved_config(str(tmp_path / "jax.yaml"))
    assert back.to_dict() == jconfig.load_saved_config(str(tmp_path / "port.yaml")).to_dict()
    assert back.to_dict() == args.to_dict() and back.exp.lr == 1e-4
    over = {"exp": {"lr": 3e-4, "new_key": [1, 2]}, "tester": {"T": 7}}
    merged = tconfig.merge_config(args, over)
    assert merged.to_dict() == jconfig.merge_config(jconfig.EasyDict(args.to_dict()),
                                                    over).to_dict()
    assert (merged.exp.lr, merged.exp.batch, merged.tester.T) == (3e-4, args.exp.batch, 7)
    assert args.exp.lr == 1e-4                      # the input is left as it was
