"""The port's int8 conv and dot (``aid_tpu_torch.ops.qconv``), its int8 and
frequency-encoded U-Nets (``network.quant: int8``, ``network.use_fencoding``)
against the JAX package's, on the CPU.

``qconv`` and ``qdot`` quantize as the JAX functions do and sum int8
products exactly in int32, so on the same inputs the outputs and the input
cotangents are the JAX bits (mirroring tests/test_qconv.py:28-107 and
:209). Whole networks sum their float parts in each framework's own order;
the tolerances say by how much.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aid_tpu import setup as asetup
from aid_tpu.models.unet_cqt import UnetCQT as JaxUnet
from aid_tpu.ops import qconv as jq
from aid_tpu.ops.cqt import get_cqt as jax_get_cqt
from aid_tpu.utils.config import compose as jcompose
from aid_tpu_torch.models import unet_cqt as tunet
from aid_tpu_torch.ops import qconv as tq
from aid_tpu_torch.ops.cqt import get_cqt
from aid_tpu_torch.utils.convert import state_dict_from_flax
from tests import test_torch_unet as tu
from tests.test_torch_trainer import TINY, _batch, _port, _port_state
from tests.torch_threads import one_torch_thread  # noqa: F401


def _int_tensor(rng, shape):
    """Integer-valued f32 with per-row max-abs 127 (quantization-exact)."""
    x = rng.integers(-127, 128, shape).astype(np.float32)
    x.reshape(shape[0], -1)[:, 0] = 127.0
    return x


def _hwio_to_oihw(w):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(w).transpose(3, 2, 0, 1)))


def _vjp_jax(f, x, g):
    return np.asarray(jax.vjp(f, jnp.asarray(x))[1](jnp.asarray(g))[0])


def _vjp_port(f, x, g):
    xs = torch.from_numpy(x).requires_grad_(True)
    (dx,) = torch.autograd.grad(f(xs), xs, torch.from_numpy(g))
    return dx.numpy()


def _conv_case(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "int":
        x = _int_tensor(rng, (2, 16, 24, 8))
        w = _int_tensor(rng, (5, 3, 8, 8))
    else:    # realistic: float activations and weights
        x = rng.standard_normal((2, 32, 20, 24)).astype(np.float32)
        w = (rng.standard_normal((5, 3, 24, 16)) / 24).astype(np.float32)
    g = rng.standard_normal(x.shape[:3] + (w.shape[3],)).astype(np.float32)
    return x, w, g


@pytest.mark.parametrize("kind", ["int", "real"])
@pytest.mark.parametrize("dilation", [1, 2, 4])
def test_qconv_is_jax_bit_for_bit(kind, dilation):
    """Output and input cotangent equal JAX's qconv exactly (SAME, frequency
    dilation), on integer-exact and on realistic inputs."""
    x, w, g = _conv_case(kind, dilation)
    wt = _hwio_to_oihw(w)
    y_ref = np.asarray(jq.qconv(jnp.asarray(x), jnp.asarray(w), (dilation, 1)))
    y = tq.qconv(torch.from_numpy(x), wt, dilation).numpy()
    np.testing.assert_array_equal(y, y_ref)
    dx_ref = _vjp_jax(lambda a: jq.qconv(a, jnp.asarray(w), (dilation, 1)), x, g)
    dx = _vjp_port(lambda a: tq.qconv(a, wt, dilation), x, g)
    np.testing.assert_array_equal(dx, dx_ref)


def test_qconv_exact_on_int_inputs_and_zero_weight_cotangent():
    """Integer-exact inputs: the f32 conv itself (tests/test_qconv.py:28);
    the weight's cotangent is zero."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(_int_tensor(rng, (2, 16, 24, 8)))
    w = _int_tensor(rng, (5, 3, 8, 8)) / 127.0
    w = torch.from_numpy(np.round(w * 127.0)).permute(3, 2, 0, 1).contiguous()
    w[:, 0, 0, 0] = 127.0
    w.requires_grad_(True)
    y = tq.qconv(x, w, 4)
    ref = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), w.detach(), padding=(8, 1),
                                     dilation=(4, 1)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(y.detach().numpy(), ref.numpy(), rtol=0, atol=1e-3)
    (dw,) = torch.autograd.grad(y.sum(), w)
    assert float(dw.abs().max()) == 0.0


@pytest.mark.parametrize("kind", ["int", "real"])
def test_qdot_is_jax_bit_for_bit(kind):
    rng = np.random.default_rng(4)
    if kind == "int":
        x, w = _int_tensor(rng, (2, 8, 16, 24)), _int_tensor(rng, (24, 48))
    else:
        x = rng.standard_normal((2, 8, 16, 24)).astype(np.float32)
        w = (rng.standard_normal((24, 48)) / 24).astype(np.float32)
    g = rng.standard_normal((2, 8, 16, 48)).astype(np.float32)
    wt = torch.from_numpy(np.ascontiguousarray(w.T))            # [N, C]
    np.testing.assert_array_equal(tq.qdot(torch.from_numpy(x), wt).numpy(),
                                  np.asarray(jq.qdot(jnp.asarray(x), jnp.asarray(w))))
    np.testing.assert_array_equal(_vjp_port(lambda a: tq.qdot(a, wt), x, g),
                                  _vjp_jax(lambda a: jq.qdot(a, jnp.asarray(w)), x, g))


@pytest.mark.parametrize("dilation", [1, 4])
def test_prequantized_conv_equals_dynamic_and_jax(dilation):
    """A prequantized kernel gives the dynamic path's bits, forward and
    backward, and JAX's prequantized ones (tests/test_qconv.py:209)."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 16, 24, 96)).astype(np.float32)
    w = (rng.standard_normal((5, 3, 96, 96)) / 96).astype(np.float32)
    g = rng.standard_normal((2, 16, 24, 96)).astype(np.float32)
    wt = _hwio_to_oihw(w)
    qw = tq.prequantize_kernel(wt, torch.float32)
    jqw = jq.prequantize_kernel(jnp.asarray(w), jnp.float32)
    y_dyn = tq.qconv(torch.from_numpy(x), wt, dilation).numpy()
    y_pre = tq.qconv(torch.from_numpy(x), wt, dilation, qw).numpy()
    np.testing.assert_array_equal(y_pre, y_dyn)
    np.testing.assert_array_equal(
        y_pre, np.asarray(jq.qconv(jnp.asarray(x), jqw, (dilation, 1))))
    dx_dyn = _vjp_port(lambda a: tq.qconv(a, wt, dilation), x, g)
    dx_pre = _vjp_port(lambda a: tq.qconv(a, wt, dilation, qw), x, g)
    np.testing.assert_array_equal(dx_pre, dx_dyn)
    np.testing.assert_array_equal(dx_pre, _vjp_jax(lambda a: jq.qconv(a, jqw, (dilation, 1)),
                                                   x, g))


def test_prequantized_dot_equals_dynamic():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 8, 16, 24)).astype(np.float32)
    w4 = torch.from_numpy((rng.standard_normal((48, 24, 1, 1)) / 24).astype(np.float32))
    g = rng.standard_normal((2, 8, 16, 48)).astype(np.float32)
    qw = tq.prequantize_kernel(w4, torch.float32)
    f_dyn, f_pre = (lambda a: tq.qdot(a, w4[:, :, 0, 0])), (lambda a: tq.qdot(a, w4[:, :, 0, 0], qw))
    np.testing.assert_array_equal(f_pre(torch.from_numpy(x)).numpy(),
                                  f_dyn(torch.from_numpy(x)).numpy())
    np.testing.assert_array_equal(_vjp_port(f_pre, x, g), _vjp_port(f_dyn, x, g))


def test_int8_mm_pads_to_the_cuda_shapes_exactly():
    """Rows, K and N padded with zeros to what _int_mm takes on CUDA (more
    than 16 rows, K and N multiples of 8): the int32 sums are unchanged."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.integers(-127, 128, (5, 15)).astype(np.int8))
    b = torch.from_numpy(rng.integers(-127, 128, (15, 3)).astype(np.int8))
    got = tq.int8_mm(a, b)
    assert got.dtype == torch.int32 and tuple(got.shape) == (5, 3)
    torch.testing.assert_close(got, a.int() @ b.int(), rtol=0, atol=0)


def test_prequant_eligibility_follows_jax():
    """1x1 kernels and spatial kernels with C_in > 64 are prequantized, the
    narrow spatial ones stay dynamic (tests/test_qconv.py:222)."""
    cases = {(16, 8, 1, 1): True, (96, 96, 5, 3): True, (64, 64, 5, 3): False}
    for shape, want in cases.items():
        assert tq.prequant_eligible(torch.ones(shape)) is want
        params = {"params": {"c": {"kernel": jnp.ones((shape[2], shape[3], shape[1],
                                                       shape[0]))}}}
        got = jq.prequantize_params(params, jnp.float32)["params"]["c"]["kernel"]
        assert isinstance(got, jq.QWeight) is want


# ------------------------------------------------------------------ networks

INT8_NET = dict(Ns=(8, 16, 16), num_dils=(1, 2, 2), attention_layers=(0, 0, 0, 0))


def _jax_net(quant="none", use_fencoding=False, net=None):
    net = net or dict(Ns=tu.NS, num_dils=tu.NUM_DILS, attention_layers=tu.ATT_LAYERS)
    return JaxUnet(cqt=jax_get_cqt(tu.O, tu.BINS, tu.FS, tu.LEN), attention=tu.ATTN,
                   emb_dim=tu.EMB, gelu="tanh", quant=quant, use_fencoding=use_fencoding, **net)


def _port_net(params, quant="none", use_fencoding=False, net=None):
    net = net or dict(Ns=tu.NS, num_dils=tu.NUM_DILS, attention_layers=tu.ATT_LAYERS)
    m = tunet.UnetCQT(get_cqt(tu.O, tu.BINS, tu.FS, tu.LEN), net["Ns"], net["num_dils"],
                      net["attention_layers"], tu.ATTN, emb_dim=tu.EMB, gelu="tanh",
                      quant=quant, use_fencoding=use_fencoding)
    m.load_state_dict(state_dict_from_flax(params))
    return m.requires_grad_(False)


def _params(module, seed):
    p = tu.trained_like(jax.jit(module.init)(jax.random.PRNGKey(seed), jnp.zeros((1, tu.LEN)),
                                             jnp.zeros((1, 1))), seed)
    return jax.tree_util.tree_map(jnp.asarray, p)


def _fwd_and_dx(jmodel, params, net, seed):
    """Both packages' forward, and the guidance backward d sum(w y)/dx."""
    audio, cnoise = tu.inputs(seed, batch=2)
    w = np.random.default_rng(seed + 1).standard_normal(audio.shape).astype(np.float32)
    cn = jnp.asarray(cnoise)
    y_ref = np.asarray(jax.jit(jmodel.apply)(params, jnp.asarray(audio), cn))
    dx_ref = np.asarray(jax.jit(jax.grad(lambda xx: jnp.sum(
        jnp.asarray(w) * jmodel.apply(params, xx, cn))))(jnp.asarray(audio)))
    x = torch.from_numpy(audio).requires_grad_(True)
    y = net(x, torch.from_numpy(cnoise))
    (dx,) = torch.autograd.grad((torch.from_numpy(w) * y).sum(), x)
    return (y.detach().numpy(), y_ref), (dx.numpy(), dx_ref)


def test_fencoding_net_matches_jax():
    """use_fencoding: 64 frequency-encoding channels on each octave (66 into
    down_{i}_init); the forward and the guidance backward within REL_TOL of
    JAX's, as the plain net (tests/test_torch_unet.py)."""
    jm = _jax_net(use_fencoding=True)
    params = _params(jm, 5)
    net = _port_net(params, use_fencoding=True)
    assert {f"freq_encodings.{i}.rff_freq" for i in range(tu.O)} <= set(net.state_dict())
    assert net.downs[0][0].res_conv.weight.shape[1] == 66
    assert not net.freq_encodings[0].rff_freq.requires_grad
    (y, y_ref), (dx, dx_ref) = _fwd_and_dx(jm, params, net, 5)
    assert np.abs(y_ref).max() > 1e-4
    assert tu.rel_err(y, y_ref) < tu.REL_TOL
    assert tu.rel_err(dx, dx_ref) < tu.REL_TOL


def test_fencoding_checkpoint_round_trip(tmp_path):
    """The converted fencoding state dict through the port's trainer: one
    step leaves the frozen frequencies where they were, a checkpoint, and a
    fresh trainer resumed from it holds the same state."""
    ov = TINY + ["network.use_fencoding=True"]
    bundle = asetup.setup_network(jcompose(overrides=ov + [f"model_dir={tmp_path}/jax"]))
    bundle.init(jax.random.PRNGKey(1), 1, 2048)
    sd = state_dict_from_flax(jax.device_get(bundle.params))
    tr = _port(str(tmp_path), ov, sd)
    assert "freq_encodings.0.rff_freq" in tr.names
    audio, fs = _batch(np.random.default_rng(0))
    tr.train_step(audio, fs)
    path = tr.save_checkpoint()
    state = _port_state(tr)
    for i in range(3):
        key = f"freq_encodings.{i}.rff_freq"
        torch.testing.assert_close(state["params"][key], sd[key], rtol=0, atol=0)
    resumed = _port(str(tmp_path), ov, sub="resumed")
    assert resumed.resume_from_checkpoint(path) and resumed.it == tr.it
    again = _port_state(resumed)
    for k in state:
        for n in state[k]:
            torch.testing.assert_close(again[k][n], state[k][n], rtol=0, atol=0, msg=f"{k} {n}")


# int8 against JAX int8: the float parts around each quantizer sum in each
# framework's own order, so a value on a rounding boundary may land one
# quantization step (1/127 of its tensor's max) away. JAX's own int8 net
# moves by 0.8% (forward) and 2.1% (input gradient) of its largest value
# when its input moves by 1e-7 relative; the tolerance is a few steps:
# 4/127 relative, forward and backward.
INT8_TOL = 4 / 127


def test_int8_net_matches_jax_int8():
    jm = _jax_net("int8", net=INT8_NET)
    params = _params(_jax_net(net=INT8_NET), 6)
    net = _port_net(params, "int8", net=INT8_NET)
    (y, y_ref), (dx, dx_ref) = _fwd_and_dx(jm, params, net, 6)
    assert np.abs(y_ref).max() > 1e-4
    assert tu.rel_err(y, y_ref) < INT8_TOL
    assert tu.rel_err(dx, dx_ref) < INT8_TOL
    # int8 is further from the f32 net than from JAX's int8
    audio, cnoise = tu.inputs(6, batch=2)
    with torch.no_grad():
        y32 = _port_net(params, net=INT8_NET)(torch.from_numpy(audio),
                                               torch.from_numpy(cnoise)).numpy()
    assert tu.rel_err(y, y32) > tu.rel_err(y, y_ref)


def test_int8_net_prequantized_equals_dynamic(monkeypatch):
    """The kernels quantized once (cached per loaded weights) give the
    dynamic path's bits through the whole net, forward and input gradient;
    a weight load refreshes the cache."""
    params = _params(_jax_net(net=INT8_NET), 7)
    net = _port_net(params, "int8", net=INT8_NET)
    assert tq.prequantize_params(net, torch.float32) > 0
    audio, cnoise = tu.inputs(7, batch=2)

    def run():
        x = torch.from_numpy(audio).requires_grad_(True)
        y = net(x, torch.from_numpy(cnoise))
        return y.detach(), torch.autograd.grad((y ** 2).sum(), x)[0]

    pre = run()
    with monkeypatch.context() as m:
        m.setattr(tq, "prequant_eligible", lambda w: False)
        dyn = run()
    for a, b in zip(pre, dyn):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    conv = net.downs[0][0].res_conv
    before = conv.qweight(torch.float32)
    with torch.no_grad():
        conv.weight.mul_(2.0)
    assert not torch.equal(conv.qweight(torch.float32).s, before.s)


def test_dequantize_kernel_matches_jax():
    """The prequantized kernel back in full precision: JAX's bits, within
    half a quantization step of each out channel's largest weight."""
    rng = np.random.default_rng(11)
    w = (rng.standard_normal((5, 3, 96, 80)) / 96).astype(np.float32)
    wt = _hwio_to_oihw(w)
    got = tq.dequantize_kernel(tq.prequantize_kernel(wt, torch.float32), torch.float32)
    ref = np.asarray(jq.dequantize_kernel(jq.prequantize_kernel(jnp.asarray(w), jnp.float32),
                                          jnp.float32))
    np.testing.assert_array_equal(got.numpy(), ref.transpose(3, 2, 0, 1))
    step = wt.abs().amax(dim=(1, 2, 3), keepdim=True) / 127.0
    assert bool(((got - wt).abs() <= 0.5 * step + 1e-7).all())
