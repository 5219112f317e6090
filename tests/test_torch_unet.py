"""The PyTorch port's U-Net against the JAX package's ``UnetCQT.apply``.

Tiny configuration (3 octaves, 8 bins, 2048 samples, Ns=(8,16,16)) with
attention and a relative-position bias on the deepest levels; JAX params are
carried across with ``aid_tpu_torch.utils.convert.state_dict_from_flax``.
Everything runs f32 on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aid_tpu.models.unet_cqt import UnetCQT as JaxUnet
from aid_tpu.models.unet_cqt import resample_time as jax_resample
from aid_tpu.ops.cqt import get_cqt as jax_get_cqt
from aid_tpu.utils.checkpoint_torch import export_state_dict
from aid_tpu_torch.models import unet_cqt as tunet
from aid_tpu_torch.ops import fused_adaln
from aid_tpu_torch.ops.cqt import get_cqt
from aid_tpu_torch.utils.containers import EasyDict
from aid_tpu_torch.utils.convert import state_dict_from_flax
from tests.torch_threads import one_torch_thread  # noqa: F401

O, BINS, LEN, FS = 3, 8, 2048, 4096.0
NS = (8, 16, 16)
NUM_DILS = (1, 2, 2)
ATT_LAYERS = (0, 1, 1, 1)
ATTN = dict(num_heads=2, bias_qkv=False, use_rel_pos=True,
            rel_pos_num_buckets=32, rel_pos_max_distance=64)
EMB = 32
# f32 on both sides; the two frameworks sum in other orders, so outputs
# agree to a few f32 ulps of the output scale, amplified by depth
REL_TOL = 1e-4


def jax_model(gelu="erf", use_pallas=False):
    return JaxUnet(cqt=jax_get_cqt(O, BINS, FS, LEN), Ns=NS, num_dils=NUM_DILS,
                   attention_layers=ATT_LAYERS, attention=ATTN, emb_dim=EMB,
                   gelu=gelu, use_pallas=use_pallas)


def torch_model(gelu="erf", dtype=torch.float32):
    return tunet.UnetCQT(get_cqt(O, BINS, FS, LEN), NS, NUM_DILS, ATT_LAYERS, ATTN,
                         emb_dim=EMB, gelu=gelu, dtype=dtype)


def trained_like(params, seed=0):
    """Redraw the gate layers (1e-7 at init) at the main layers' scale, as in
    a trained net, so every conv stack, and so every norm x adaLN x GELU,
    moves the output."""
    rng = np.random.default_rng(seed)

    def redraw(path, v):
        names = [getattr(k, "key", "") for k in path]
        v = np.asarray(v)
        if any(n.startswith("gate_") for n in names) and names[-1] == "kernel":
            bound = np.sqrt(3.0 / v.shape[0]) * np.sqrt(1.0 / 3.0)
            return rng.uniform(-bound, bound, v.shape).astype(np.float32)
        return v

    return jax.tree_util.tree_map_with_path(redraw, params)


@pytest.fixture(scope="module")
def jax_params():
    x = jnp.zeros((1, LEN))
    cn = jnp.zeros((1, 1))
    return trained_like(jax.jit(jax_model().init)(jax.random.PRNGKey(3), x, cn))


def inputs(seed=0, batch=2):
    rng = np.random.default_rng(seed)
    audio = (rng.standard_normal((batch, LEN)) * 0.1).astype(np.float32)
    cnoise = rng.standard_normal((batch, 1)).astype(np.float32)
    return audio, cnoise


def rel_err(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / (np.abs(np.asarray(b)).max() + 1e-30))


def test_every_flax_leaf_maps_to_one_port_parameter(jax_params):
    sd = state_dict_from_flax(jax_params)
    leaves = jax.tree_util.tree_leaves(jax_params["params"])
    net = torch_model()
    port = net.state_dict()
    assert len(sd) == len(leaves)
    assert set(sd) == set(port)
    for k, v in sd.items():
        assert tuple(v.shape) == tuple(port[k].shape), k
    # the port's copy of the map agrees with the JAX package's exporter
    ref = export_state_dict(jax_params)
    assert set(ref) == set(sd)
    for k in ref:
        np.testing.assert_array_equal(ref[k], sd[k].numpy())
    net.load_state_dict(sd)  # strict: no missing or unexpected key


@pytest.mark.parametrize("gelu,use_pallas", [("erf", True), ("tanh", False),
                                             ("sigmoid", False)])
def test_forward_matches_jax(jax_params, gelu, use_pallas):
    audio, cnoise = inputs()
    y_jax = np.asarray(jax.jit(jax_model(gelu, use_pallas).apply)(
        jax_params, jnp.asarray(audio), jnp.asarray(cnoise)))
    net = torch_model(gelu)
    net.load_state_dict(state_dict_from_flax(jax_params))
    with torch.no_grad():
        y = net(torch.from_numpy(audio), torch.from_numpy(cnoise)).numpy()
    assert y.shape == audio.shape and y.dtype == np.float32
    assert np.abs(y_jax).max() > 1e-4        # a non-trivial output
    err = rel_err(y, y_jax)
    assert err < REL_TOL, err


def test_input_gradient_matches_jax(jax_params):
    """The guidance backward: d sum(w * net(x)) / dx, real input, real loss."""
    audio, cnoise = inputs(1, batch=1)
    w = np.random.default_rng(2).standard_normal(audio.shape).astype(np.float32)
    m = jax_model("tanh")

    def loss(x, params):
        return jnp.sum(jnp.asarray(w) * m.apply(params, x, jnp.asarray(cnoise)))

    g_jax = np.asarray(jax.jit(jax.grad(loss))(jnp.asarray(audio), jax_params))
    net = torch_model("tanh")
    net.load_state_dict(state_dict_from_flax(jax_params))
    net.requires_grad_(False)
    x = torch.from_numpy(audio).requires_grad_(True)
    (g,) = torch.autograd.grad((torch.from_numpy(w) * net(x, torch.from_numpy(cnoise))).sum(), x)
    err = rel_err(g.numpy(), g_jax)
    assert err < REL_TOL, err


def test_plain_and_fused_paths_agree_on_cpu(jax_params, monkeypatch):
    """On CPU tensors the kernel's wrapper takes the plain version, so the
    model gives the same numbers as with the plain version patched in, and
    launches nothing."""
    audio, cnoise = inputs(3)
    net = torch_model("tanh")
    net.load_state_dict(state_dict_from_flax(jax_params))
    fused_adaln.reset_launch_count()
    with torch.no_grad():
        a = net(torch.from_numpy(audio), torch.from_numpy(cnoise))
        monkeypatch.setattr(fused_adaln, "norm_adaln_gelu",
                            fused_adaln.norm_adaln_gelu_plain)
        b = net(torch.from_numpy(audio), torch.from_numpy(cnoise))
    assert fused_adaln.launch_count() == 0
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_bf16_forward_is_finite(jax_params):
    audio, cnoise = inputs(4)
    net = torch_model("tanh", dtype=torch.bfloat16)
    net.load_state_dict(state_dict_from_flax(jax_params))
    net.store_weights_in_compute_dtype()
    with torch.no_grad():
        y = net(torch.from_numpy(audio), torch.from_numpy(cnoise))
    assert y.dtype == torch.float32 and torch.isfinite(y).all()


@pytest.mark.parametrize("up", [False, True])
def test_resample_time_matches_jax(up):
    x = np.random.default_rng(5).standard_normal((2, 3, 32, 6)).astype(np.float32)
    a = np.asarray(jax_resample(jnp.asarray(x), up))
    b = tunet.resample_time(torch.from_numpy(x), up).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("F_,d", [(16, 1), (16, 2), (16, 8), (12, 8), (10, 4), (6, 16)])
def test_folded_dilated_conv_matches_direct_conv(F_, d):
    """Conv2dFT folds a frequency dilation into the batch; it equals the
    SAME-padded dilated conv, also where F is no multiple of d, and in the
    input gradient (f32, summation-order tolerance)."""
    rng = np.random.default_rng(d)
    conv = tunet.Conv2dFT(6, 5, (5, 3), dilation=(d, 1))
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(rng.standard_normal((5, 6, 5, 3)).astype(np.float32)))
    x = torch.from_numpy(rng.standard_normal((2, F_, 7, 6)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((2, F_, 7, 5)).astype(np.float32))
    xs = [x.clone().requires_grad_(True) for _ in range(2)]
    got = conv(xs[0])
    ref = torch.nn.functional.conv2d(xs[1].permute(0, 3, 1, 2), conv.weight,
                                     padding=(2 * d, 1), dilation=(d, 1)).permute(0, 2, 3, 1)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    (ga,) = torch.autograd.grad(got, xs[0], g)
    (gb,) = torch.autograd.grad(ref, xs[1], g)
    torch.testing.assert_close(ga, gb, rtol=1e-5, atol=1e-5)


def _net_args(**net_over):
    net = dict(callable="aid_tpu_torch.models.unet_cqt.build_unet",
               cqt=dict(window="kaiser", beta=1, num_octs=O, bins_per_oct=BINS),
               Ns=list(NS), num_dils=list(NUM_DILS), attention_layers=list(ATT_LAYERS),
               attention_dict=dict(ATTN), emb_dim=EMB, use_norm=True,
               use_fencoding=False, gelu="tanh", compute_dtype="float32")
    net.update(net_over)
    return EasyDict(network=net, exp=dict(sample_rate=FS, audio_len=LEN))


@pytest.mark.parametrize("key,value", [("quant", "int8"), ("context_parallel", True),
                                       ("remat", True), ("use_fencoding", True)])
def test_unported_network_options_raise(key, value):
    with pytest.raises(NotImplementedError):
        tunet.build_unet(_net_args(**{key: value}))


def test_tpu_layout_keys_are_ignored():
    a = tunet.build_unet(_net_args()).init_weights(0)
    b = tunet.build_unet(_net_args(conv_foldf=True, conv_pack_stack=True,
                                   conv_chain_regroup=True, chain_stride=3,
                                   use_pallas_fused=True)).init_weights(0)
    assert a.state_dict().keys() == b.state_dict().keys()
    audio, cnoise = inputs(6, batch=1)
    with torch.no_grad():
        torch.testing.assert_close(a(torch.from_numpy(audio), torch.from_numpy(cnoise)),
                                   b(torch.from_numpy(audio), torch.from_numpy(cnoise)),
                                   rtol=0, atol=0)
