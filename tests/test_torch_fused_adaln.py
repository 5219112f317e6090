"""The port's fused norm x adaLN x GELU against the JAX package.

erf: the plain version against JAX ``norm_adaln_gelu``, whose Pallas kernel
runs interpreted on the CPU (as tests/test_pallas.py runs it): forward at
2e-5, gradients at 3e-4 (the tolerances of tests/test_pallas.py). tanh and
sigmoid: against JAX ``_norm_adaln_scale`` + ``_gelu``. On a CUDA tensor the
wrapper launches the Triton kernel; its tests are in tests/test_torch_cuda.py,
which imports no JAX so that it runs on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aid_tpu.models.unet_cqt import _gelu, _norm_adaln_scale
from aid_tpu.ops.pallas.fused_adaln import group_std as jax_group_std
from aid_tpu.ops.pallas.fused_adaln import norm_adaln_gelu as jax_norm_adaln_gelu
from aid_tpu_torch.ops import fused_adaln as fa
from tests.torch_threads import one_torch_thread  # noqa: F401

EPS, G = 1e-7, 8


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 16, 16)).astype(np.float32)
    gamma = (rng.standard_normal(16) * 0.1 + 1.0).astype(np.float32)
    aff = (rng.standard_normal((2, 16)) * 0.3).astype(np.float32)
    return x, gamma, aff


def _torch_fn(x, gamma, aff, gelu):
    return fa.norm_adaln_gelu(x, fa.group_std(x, G), gamma, aff, EPS, G, gelu=gelu)


def _jax_fn(x, gamma, aff, gelu):
    if gelu == "erf":
        return jax_norm_adaln_gelu(x, jax_group_std(x, G), gamma, aff, EPS, G)
    return _gelu(_norm_adaln_scale(x, gamma, aff, EPS, G), gelu)


def _torch_grads(x, gamma, aff, gelu):
    t = [torch.from_numpy(a).requires_grad_(True) for a in (x, gamma, aff)]
    loss = (_torch_fn(*t, gelu) ** 2).sum()
    return [g.numpy() for g in torch.autograd.grad(loss, t)]


def _jax_grads(x, gamma, aff, gelu):
    def loss(x, gamma, aff):
        return jnp.sum(_jax_fn(x, gamma, aff, gelu) ** 2)
    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(aff))]


@pytest.mark.parametrize("gelu", fa.GELU_VARIANTS)
def test_forward_matches_jax(data, gelu):
    x, gamma, aff = data
    ref = np.asarray(_jax_fn(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(aff), gelu))
    with torch.no_grad():
        got = _torch_fn(*(torch.from_numpy(a) for a in data), gelu).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("gelu", fa.GELU_VARIANTS)
def test_grads_match_jax(data, gelu):
    for a, b in zip(_torch_grads(*data, gelu), _jax_grads(*data, gelu)):
        np.testing.assert_allclose(a, b, atol=3e-4, rtol=3e-4)


@pytest.mark.parametrize("gelu", fa.GELU_VARIANTS)
def test_function_backward_matches_autograd_of_plain(data, gelu):
    """The autograd.Function's hand backward equals autograd through the
    plain composition (f32, summation-order tolerance)."""
    t1 = [torch.from_numpy(a).requires_grad_(True) for a in data]
    t2 = [torch.from_numpy(a).requires_grad_(True) for a in data]
    l1 = (fa.norm_adaln_gelu(t1[0], fa.group_std(t1[0], G), t1[1], t1[2], EPS, G,
                             gelu=gelu) ** 3).sum()
    l2 = (fa.norm_adaln_gelu_plain(t2[0], fa.group_std(t2[0], G), t2[1], t2[2], EPS, G,
                                   gelu=gelu) ** 3).sum()
    for a, b in zip(torch.autograd.grad(l1, t1), torch.autograd.grad(l2, t2)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_group_std_matches_jax(data):
    x = data[0]
    np.testing.assert_allclose(fa.group_std(torch.from_numpy(x), G).numpy(),
                               np.asarray(jax_group_std(jnp.asarray(x), G)),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_tensor_takes_plain_version(data, dtype):
    x, gamma, aff = (torch.from_numpy(a) for a in data)
    x = x.to(dtype)
    fa.reset_launch_count()
    with torch.no_grad():
        y = fa.norm_adaln_gelu(x, fa.group_std(x, G), gamma, aff, EPS, G, gelu="tanh")
        yp = fa.norm_adaln_gelu_plain(x, fa.group_std(x, G), gamma, aff, EPS, G, gelu="tanh")
    assert fa.launch_count() == 0
    assert y.dtype == dtype and y.shape == x.shape
    torch.testing.assert_close(y, yp, rtol=0, atol=0)


def _bad_inputs(kind, x, gamma, aff):
    std = fa.group_std(x, G)
    if kind == "non_contiguous":
        x = x.transpose(1, 2)
        std = fa.group_std(x, G)
    elif kind == "dtype":
        x = x.double()
    elif kind == "rank":
        x = x[0]
    elif kind == "table_shape":
        aff = aff[:, :8]
    return x, std, gamma, aff


@pytest.mark.parametrize("kind", ["non_contiguous", "dtype", "rank", "table_shape",
                                  "gelu"])
def test_wrapper_rejects_what_the_kernel_does_not_take(data, kind):
    x, gamma, aff = (torch.from_numpy(a) for a in data)
    x, std, gamma, aff = _bad_inputs(kind, x, gamma, aff)
    gelu = "relu" if kind == "gelu" else "erf"
    with pytest.raises((ValueError, TypeError)):
        fa.norm_adaln_gelu(x, std, gamma, aff, EPS, G, gelu=gelu)


def test_cpu_tensor_takes_plain_backward(data, monkeypatch):
    """A CPU tensor's backward is the plain version and launches nothing; the
    plain version forms dv * x once for both table gradients."""
    calls = []
    plain = fa.fused_bwd_plain

    def spy(*a):
        calls.append(a[-2:])
        return plain(*a)

    monkeypatch.setattr(fa, "fused_bwd_plain", spy)
    x, gamma, aff = (torch.from_numpy(a).requires_grad_(True) for a in data)
    fa.reset_launch_count()
    y = fa.norm_adaln_gelu(x, fa.group_std(x, G), gamma, aff, EPS, G, gelu="tanh")
    torch.autograd.grad(y.sum(), (x, gamma, aff))
    assert calls == [(True, True)]
    assert (fa.launch_count(), fa.bwd_launch_count()) == (0, 0)


def test_cuda_tensor_never_takes_plain_backward(monkeypatch):
    """A CUDA tensor goes to the kernel's wrapper, never to the plain
    version (no fallback); another device raises."""
    seen = []
    monkeypatch.setattr(fa, "fused_bwd_plain", lambda *a: pytest.fail("plain backward"))
    monkeypatch.setattr(fa, "_fused_bwd_cuda", lambda *a: seen.append(a[-2:]) or (None, None))

    class Cuda:
        device = torch.device("cuda")

    fa._fused_backward(Cuda(), None, None, None, "tanh", True, False)
    assert seen == [(True, False)]
    with pytest.raises(ValueError):
        fa._fused_backward(torch.empty(1, device="meta"), None, None, None, "tanh", True, True)


@pytest.mark.parametrize("gelu", fa.GELU_VARIANTS)
def test_plain_backward_matches_autograd_of_plain_forward(data, gelu):
    """``fused_bwd_plain`` (the kernel's plain version): dx and the row sum
    q, with dinv = q mod and dmod = q inv, equal autograd through
    ``fused_plain``."""
    x = torch.from_numpy(data[0]).reshape(2, 128, 16)
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(0))
    inv = (torch.rand(2, 16, generator=torch.Generator().manual_seed(1)) + 0.5)
    mod = (torch.rand(2, 16, generator=torch.Generator().manual_seed(2)) + 0.5)
    t = [a.clone().requires_grad_(True) for a in (x, inv, mod)]
    want = torch.autograd.grad(fa.fused_plain(*t, gelu), t, g)
    dx, q = fa.fused_bwd_plain(x, g, inv, mod, gelu)
    for a, b in zip((dx, q * mod, q * inv), want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    assert fa.fused_bwd_plain(x, g, inv, mod, gelu, need_q=False)[1] is None
    assert fa.fused_bwd_plain(x, g, inv, mod, gelu, need_dx=False)[0] is None


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("B", [1, 2, 4])
@pytest.mark.parametrize("R,C", [(262144, 64), (131072, 96), (14336, 256), (2048, 256),
                                 (4099, 96), (77, 64), (1, 48)])
def test_bwd_tile_covers_the_rows_once(B, R, C, itemsize):
    """The backward's grid: power-of-two blocks that hold C, programs that
    each own at least one row and together every row once, and no more
    programs across the batch than the grid aims at (unless one a tile)."""
    block_r, block_c, per_prog, P, warps = fa._bwd_tile(B, R, C, itemsize)
    rows = per_prog * block_r
    assert block_c >= C and block_c & (block_c - 1) == 0 and block_r & (block_r - 1) == 0
    assert (P - 1) * rows < R <= P * rows
    assert B * P <= max(fa._BWD_PROGRAMS, B) or per_prog == 1
    assert warps in (1, 2, 4, 8, 16) and fa._bwd_tile(B, R, C, itemsize)[3] == P


def test_launch_counts_apart_and_in_the_trace_snapshot():
    """The forward's and the backward's launches are counted apart (a replay
    adds both what its capture recorded) and reported by
    ``trace.snapshot()``; ``reset_launch_count`` zeroes both."""
    from aid_tpu_torch.utils import trace
    fa.reset_launch_count()
    trace.replayed_launches({"fused_adaln": (90, 90)})
    trace.replayed_launches({"fused_adaln": (180, 0)})
    assert (fa.launch_count(), fa.bwd_launch_count()) == (270, 90)
    counters = trace.snapshot()["counters"]
    assert counters["fused_adaln.launches"] == 270
    assert counters["fused_adaln.bwd_launches"] == 90
    assert trace.captured_launches()["fused_adaln"] == (0, 0)
    fa.reset_launch_count()
    assert (fa.launch_count(), fa.bwd_launch_count()) == (0, 0)
