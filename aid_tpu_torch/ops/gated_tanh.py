"""DiffWave's gate, sigmoid(gate) x tanh(filter), in one pass (Triton on Hopper).

Every residual layer of ``models.diffwave`` splits its dilated conv's output
``z`` [B, 2C, L] (channels first) into ``gate = z[:, :C]`` and ``filter =
z[:, C:]`` and computes

    g = sigmoid(gate) * tanh(filter)            [B, C, L]

in ``z``'s dtype, with f32 math.

Kernel note. This replaces no TPU kernel: the JAX package has no DiffWave.
It was added because PyTorch runs the gate as several full-size passes
(two reads of the halves, a sigmoid, a tanh, a product, each through device
memory) and its autograd as several more, and DiffWave computes it 36 times
a forward at [B, 2C, 131072]. It does a few f32 operations an element and
no tensor-core work, so it is bound by HBM bytes: the forward reads z once
and writes g once (``3 * bytes(g)`` a launch), the backward, ``_gated_tanh_bwd``,
reads z and dg once and writes dz once (``5 * bytes(g)``). Each program
takes one contiguous block of ``BLOCK`` elements of one batch row's gate
half and the block at the same offset of its filter half, so every load and
store is a wide coalesced run; the dtype is a compile-time specialisation.
tanh is computed as 2 sigmoid(2 f) - 1 and its derivative as
4 sigmoid(2 f) (1 - sigmoid(2 f)), with no cancellation that grows with |f|.

Dispatch, both directions: a CPU tensor takes the plain version; a CUDA
tensor launches the kernel or raises. ``triton`` is imported inside the
CUDA branch only.
"""
from __future__ import annotations

import torch

from aid_tpu_torch.utils import trace

# Launches of the Triton kernels, the forward's and the backward's apart
# (``trace.Launches``: a capture's launches counted apart, added by each
# replay).
LAUNCHES = trace.Launches("gated_tanh")


# ------------------------------------------------------------------ plain


def _math_dtype(dtype: torch.dtype) -> torch.dtype:
    """f32 math for the half types, the input's own type otherwise (f64
    stays f64, for gradcheck)."""
    return torch.promote_types(dtype, torch.float32)


def gated_tanh_plain(z: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the forward kernel: z [B, 2C, L] -> [B, C, L]."""
    a, f = z.to(_math_dtype(z.dtype)).chunk(2, dim=1)
    return (torch.sigmoid(a) * torch.tanh(f)).to(z.dtype)


def gated_tanh_bwd_plain(z: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the backward kernel: dz [B, 2C, L] in z's dtype
    for the output gradient ``g`` [B, C, L]."""
    m = _math_dtype(z.dtype)
    a, f = z.to(m).chunk(2, dim=1)
    g = g.to(m)
    sa, th = torch.sigmoid(a), torch.tanh(f)
    return torch.cat([g * th * sa * (1.0 - sa), g * sa * (1.0 - th * th)], dim=1).to(z.dtype)


# ----------------------------------------------------------------- kernel

_KERNEL = None
_BWD_KERNEL = None
BLOCK = 4096
WARPS = 8


def _build_kernel():
    """Define the forward Triton kernel on first CUDA use (``triton`` is
    absent on CPU-only installs, and tests import this module)."""
    global _KERNEL
    if _KERNEL is not None:
        return _KERNEL
    import triton
    import triton.language as tl

    @triton.jit
    def _gated_tanh_fwd(z_ptr, g_ptr, N, BLOCK: tl.constexpr):
        # N = C L elements a half; program (i, b) takes elements
        # [i BLOCK, (i + 1) BLOCK) of row b's gate half and its filter half
        pid = tl.program_id(0)
        b = tl.program_id(1).to(tl.int64)
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        m = offs < N
        zb = b * 2 * N
        a = tl.load(z_ptr + zb + offs, mask=m, other=0.0).to(tl.float32)
        f = tl.load(z_ptr + zb + N + offs, mask=m, other=0.0).to(tl.float32)
        g = tl.sigmoid(a) * (2.0 * tl.sigmoid(2.0 * f) - 1.0)
        tl.store(g_ptr + b * N + offs, g.to(g_ptr.dtype.element_ty), mask=m)

    _KERNEL = _gated_tanh_fwd
    return _KERNEL


def _build_bwd_kernel():
    """Define the backward Triton kernel on first CUDA use."""
    global _BWD_KERNEL
    if _BWD_KERNEL is not None:
        return _BWD_KERNEL
    import triton
    import triton.language as tl

    @triton.jit
    def _gated_tanh_bwd(z_ptr, dg_ptr, dz_ptr, N, BLOCK: tl.constexpr):
        pid = tl.program_id(0)
        b = tl.program_id(1).to(tl.int64)
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        m = offs < N
        zb = b * 2 * N
        a = tl.load(z_ptr + zb + offs, mask=m, other=0.0).to(tl.float32)
        f = tl.load(z_ptr + zb + N + offs, mask=m, other=0.0).to(tl.float32)
        dg = tl.load(dg_ptr + b * N + offs, mask=m, other=0.0).to(tl.float32)
        sa = tl.sigmoid(a)
        s2 = tl.sigmoid(2.0 * f)
        th = 2.0 * s2 - 1.0
        da = dg * th * sa * (1.0 - sa)
        df = dg * sa * 4.0 * s2 * (1.0 - s2)
        tl.store(dz_ptr + zb + offs, da.to(dz_ptr.dtype.element_ty), mask=m)
        tl.store(dz_ptr + zb + N + offs, df.to(dz_ptr.dtype.element_ty), mask=m)

    _BWD_KERNEL = _gated_tanh_bwd
    return _BWD_KERNEL


def _gated_cuda(z: torch.Tensor) -> torch.Tensor:
    kernel = _build_kernel()
    B, C2, L = z.shape
    N = C2 // 2 * L
    g = torch.empty((B, C2 // 2, L), dtype=z.dtype, device=z.device)
    kernel[(-(-N // BLOCK), B)](z, g, N, BLOCK=BLOCK, num_warps=WARPS)
    LAUNCHES.launched()
    return g


def _gated_bwd_cuda(z: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    kernel = _build_bwd_kernel()
    B, C2, L = z.shape
    N = C2 // 2 * L
    g = g.to(z.dtype).contiguous()
    dz = torch.empty_like(z)
    kernel[(-(-N // BLOCK), B)](z, g, dz, N, BLOCK=BLOCK, num_warps=WARPS)
    LAUNCHES.launched(bwd=True)
    return dz


def _forward(z):
    if z.device.type == "cuda":
        return _gated_cuda(z)
    if z.device.type == "cpu":
        return gated_tanh_plain(z)
    raise ValueError(f"gated_tanh: unsupported device {z.device}")


def _backward(z, g):
    if z.device.type == "cuda":
        return _gated_bwd_cuda(z, g)
    if z.device.type == "cpu":
        return gated_tanh_bwd_plain(z, g)
    raise ValueError(f"gated_tanh: unsupported device {z.device}")


class _Gate(torch.autograd.Function):
    """g = sigmoid(gate) tanh(filter), forward and backward through the
    kernels (or their plain versions on the CPU); saves z alone."""

    @staticmethod
    def forward(ctx, z):
        ctx.save_for_backward(z)
        return _forward(z)

    @staticmethod
    def backward(ctx, g):
        (z,) = ctx.saved_tensors
        return _backward(z, g)


def gated_tanh(z: torch.Tensor) -> torch.Tensor:
    """sigmoid(z[:, :C]) * tanh(z[:, C:]) for a contiguous z [B, 2C, L];
    returns [B, C, L] in z's dtype. Differentiable in z."""
    if z.dim() != 3 or z.shape[1] % 2:
        raise ValueError(f"z must be [B, 2C, L], got shape {tuple(z.shape)}")
    if z.device.type == "cuda" and z.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the gate kernel takes float32 or bfloat16, got {z.dtype}")
    if not z.is_contiguous():
        raise ValueError(f"z must be contiguous (strides {z.stride()})")
    return _Gate.apply(z)
