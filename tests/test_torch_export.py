"""Checkpoints across the two packages: the port's reference-layout export
(``export_checkpoint``, ``export_checkpoint_from``) read by the JAX
package, the JAX package's export read by the port, and an orbax checkpoint
of the JAX trainer converted by ``scripts/orbax_to_stream.py`` and resumed
by the port's trainer. Tiny network, f32, on the CPU."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aid_tpu import setup as asetup
from aid_tpu.diffusion import edm as jedm
from aid_tpu.utils import checkpoint_torch as jct
from aid_tpu.utils import ckpt_io as jckpt_io
from aid_tpu.utils.config import compose as jcompose
from aid_tpu_torch import setup as tsetup
from aid_tpu_torch.diffusion import edm
from aid_tpu_torch.models.unet_cqt import MAIN_SCALE
from aid_tpu_torch.utils import checkpoint as ckpt
from aid_tpu_torch.utils import checkpoint_torch as tct
from aid_tpu_torch.utils import ckpt_io
from aid_tpu_torch.utils.config import compose
from aid_tpu_torch.utils.convert import state_dict_from_flax
from tests.torch_threads import one_torch_thread  # noqa: F401

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "scripts"))
import orbax_to_stream  # noqa: E402

L = 2048
TINY = [f"exp.audio_len={L}", "exp.batch=2", "exp.total_its=2", "exp.lr_rampup_it=1",
        "network.cqt.num_octs=3", "network.cqt.bins_per_oct=8", "network.Ns=[8,16,16]",
        "network.num_dils=[1,2,2]", "network.attention_layers=[0,0,1,1]",
        "network.compute_dtype=float32", "network.remat=False",
        "logging.print_model_summary=False", "logging.save_interval=100"]
DENOISER_TOL = 1e-5      # max|d| / max|ref|, f32 on both sides


def _port_net(seed, tmp):
    args = compose(overrides=TINY + [f"model_dir={tmp}"])
    net = tsetup.setup_network(args, device="cpu", seed=seed)
    return args, net


def _jax_bundle(tmp):
    ja = jcompose(overrides=TINY + [f"model_dir={tmp}"])
    bundle = asetup.setup_network(ja)
    bundle.init(jax.random.PRNGKey(0), 1, L)
    return ja, bundle


def _inputs():
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((2, L)) * 0.1).astype(np.float32)
    return x, np.asarray([[0.05], [0.8]], np.float32)


def test_port_export_loads_in_jax_with_the_same_denoiser(tmp_path):
    """Port export_checkpoint -> JAX load_reference_checkpoint (its EMA) ->
    the JAX denoiser equals the port's on the same input."""
    args, net = _port_net(0, tmp_path)
    net.init_weights(0, gate_scale=MAIN_SCALE)         # trained-like gates
    ema_net = _port_net(1, tmp_path)[1].init_weights(1, gate_scale=MAIN_SCALE)
    path = tct.export_checkpoint(str(tmp_path / "net-3.pt"), net, it=3,
                                 ema=ema_net.state_dict())
    payload = torch.load(path, map_location="cpu", weights_only=True)
    assert set(payload) == {"it", "network", "ema", "optimizer"} and payload["it"] == 3
    assert payload["optimizer"] == {}
    assert all(v.dtype == torch.float32 and v.device.type == "cpu"
               for sd in (payload["network"], payload["ema"]) for v in sd.values())

    ja, bundle = _jax_bundle(tmp_path)
    bundle.params = jct.load_reference_checkpoint(path, bundle)
    x, sigma = _inputs()
    p = asetup.setup_diff_parameters(ja).params
    ref = np.asarray(jax.jit(lambda xx, ss: jedm.denoiser(
        p, lambda q, cn: bundle.module.apply(bundle.params, q, cn), xx, ss))(
            jnp.asarray(x), jnp.asarray(sigma)))
    with torch.no_grad():
        got = edm.denoiser(tsetup.setup_diff_parameters(args).params, ema_net,
                           torch.from_numpy(x), torch.from_numpy(sigma)).numpy()
    assert np.abs(got - ref).max() / np.abs(ref).max() < DENOISER_TOL


def test_jax_export_loads_in_the_port_bit_equal(tmp_path):
    _, bundle = _jax_bundle(tmp_path)
    ema = jax.tree_util.tree_map(lambda v: v * 0.5, bundle.params)
    path = jct.export_checkpoint(str(tmp_path / "ref-9.pt"), bundle, it=9, ema_params=ema)
    _, net = _port_net(3, tmp_path)
    tct.load_reference_checkpoint(path, net)
    want = state_dict_from_flax(jax.device_get(ema))
    got = net.state_dict()
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


def test_export_checkpoint_refuses_an_ema_of_other_names(tmp_path):
    _, net = _port_net(0, tmp_path)
    ema = dict(net.state_dict())
    ema.pop(next(iter(ema)))
    with pytest.raises(KeyError):
        tct.export_checkpoint(str(tmp_path / "x.pt"), net, ema=ema)


@pytest.fixture(scope="module")
def trained_pair(tmp_path_factory):
    """The JAX trainer after 2 steps, its state saved with orbax (the
    pre-stream format) and converted by scripts/orbax_to_stream.py."""
    tmp = tmp_path_factory.mktemp("orbax")
    ja = jcompose(overrides=TINY + [f"model_dir={tmp}"])
    jtr = asetup.setup_trainer(ja, network=asetup.setup_network(ja),
                               diff_params=asetup.setup_diff_parameters(ja))
    jtr.init_state()
    rng = np.random.default_rng(0)
    for _ in range(2):
        jtr.train_step((rng.standard_normal((2, L)) * 0.1).astype(np.float32),
                       np.full((2,), 22050, np.int64))
    s = jax.device_get(jtr.state)
    import orbax.checkpoint as ocp
    src = str(tmp / "orbax_run")
    ocp.PyTreeCheckpointer().save(src, {"it": int(s.it), "network": s.params, "ema": s.ema,
                                        "optimizer": s.opt_state,
                                        "gnorm_ema": float(s.gnorm_ema),
                                        "applied": int(s.applied)})
    return tmp, src, s


def test_the_port_refuses_orbax_and_names_the_converter(trained_pair):
    _, src, _ = trained_pair
    assert not jckpt_io.is_stream(src)
    with pytest.raises(ValueError, match="scripts/orbax_to_stream.py"):
        ckpt.load(src)


def test_orbax_converts_and_resumes_in_the_port(trained_pair):
    tmp, src, s = trained_pair
    dst = str(tmp / "22k_8s-2.ckpt")
    assert orbax_to_stream.main([src, dst]) == 0
    assert ckpt_io.is_stream(dst)
    args = compose(overrides=TINY + [f"model_dir={tmp}"])
    net = tsetup.setup_network(args, device="cpu", seed=5, trainable=True)
    tr = tsetup.setup_trainer(args, network=net, diff_params=tsetup.setup_diff_parameters(args))
    assert ckpt.list_checkpoints(str(tmp), "22k_8s") == [dst]
    assert tr.resume_from_checkpoint()
    adam = s.opt_state[1]
    for name, ts, tree in (("params", tr.params, s.params), ("ema", tr.ema, s.ema),
                           ("mu", tr.mu, adam.mu), ("nu", tr.nu, adam.nu)):
        want = state_dict_from_flax(tree)
        for n, t in zip(tr.names, ts):
            np.testing.assert_array_equal(t.detach().numpy(), want[n].numpy(), err_msg=name + n)
    assert (tr.it, int(tr.count), int(tr.applied)) == (int(s.it), int(adam.count),
                                                       int(s.applied))


def test_orbax_to_stream_usage_and_same_path(trained_pair, capsys):
    _, src, _ = trained_pair
    assert orbax_to_stream.main([src]) == 2
    assert "usage" in capsys.readouterr().err
    with pytest.raises(ValueError):
        orbax_to_stream.convert(src, src)


def test_export_checkpoint_from_a_training_checkpoint(trained_pair, tmp_path):
    """export_checkpoint_from turns the port's training checkpoint and a
    JAX stream checkpoint into a reference .pt that loads back bit-equal."""
    tmp, _, s = trained_pair
    stream = str(tmp / "22k_8s-2.ckpt")
    if not ckpt_io.is_stream(stream):
        jckpt_io.save_stream(stream, {"it": int(s.it), "network": s.params, "ema": s.ema,
                                      "optimizer": s.opt_state})
    args = compose(overrides=TINY + [f"model_dir={tmp_path}"])
    net = tsetup.setup_network(args, device="cpu", seed=2, trainable=True)
    tr = tsetup.setup_trainer(args, network=net, diff_params=tsetup.setup_diff_parameters(args))
    tr.init_state()
    port_ckpt = tr.save_checkpoint()
    for src, ema in ((port_ckpt, dict(zip(tr.names, tr.ema))),
                     (stream, state_dict_from_flax(s.ema))):
        out = tct.export_checkpoint_from(src, str(tmp_path / "ref.pt"))
        payload = torch.load(out, map_location="cpu", weights_only=True)
        assert set(payload) == {"it", "network", "ema", "optimizer"}
        _, fresh = _port_net(9, tmp_path)
        tct.load_reference_checkpoint(out, fresh)
        for k, v in fresh.state_dict().items():
            torch.testing.assert_close(v, ema[k].float(), rtol=0, atol=0)
