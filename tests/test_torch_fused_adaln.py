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
