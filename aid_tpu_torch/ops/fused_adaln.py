"""Fused bias-free group-norm scale x adaLN modulation x GELU (Triton on Hopper).

The prologue of every dilated conv in every ``AdaLNResBlock`` is

    y = gelu(x * inv * mod),   inv = gamma / (group_std(x) + eps),   mod = 1 + aff

with ``x`` a channels-last activation ``[B, F, T, C]`` and ``inv``, ``mod``
per-(batch, channel) f32 tables. The math is f32 and ``y`` takes x's dtype.

Kernel note. This replaces the TPU kernel
``aid_tpu/ops/pallas/fused_adaln.py::_fused_fwd_impl``. On the H100 it does a
few f32 operations per element and no tensor-core work, so it is bound by
HBM bytes: one read and one write of x, ``2 * bytes(x)`` per launch (the two
``[B, C]`` tables are negligible). The tile design is about moving those
bytes at full rate and nothing else: each program takes ``BLOCK_R`` whole
rows of the ``[B, R, C]`` view, which are one contiguous run of memory, so
every warp issues wide coalesced loads and stores; it loads the ``[C]``
scale of its batch row once and broadcasts it over the tile in registers, so
no table is read per element; the GELU variant and the dtype are
compile-time specialisations, so the body carries no branch. ``group_std``
stays a torch reduction outside the kernel, as in the JAX package.

The backward is plain torch (as the JAX backward is plain XLA), inside a
``torch.autograd.Function``; a fused backward kernel is later work.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises. ``triton`` is imported inside the CUDA branch only.
"""
from __future__ import annotations

import math

import torch

GELU_VARIANTS = ("erf", "tanh", "sigmoid")
_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)
_INV_SQRT2PI = 1.0 / math.sqrt(2.0 * math.pi)

# Launches of the Triton kernel. The wrapper adds one per launch; a launch
# that a CUDA graph capture records instead goes to ``_captured``, and each
# replay of that graph adds what it recorded (``add_replayed_launches``).
# Nothing else touches them except ``reset_launch_count``.
_launches = 0
_captured = 0


def launch_count() -> int:
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def captured_count() -> int:
    """Launches recorded by CUDA graph captures so far (not run by them)."""
    return _captured


def add_replayed_launches(n: int) -> None:
    """A replay of a CUDA graph that recorded ``n`` launches launched them."""
    global _launches
    _launches += n


# ------------------------------------------------------------------ plain


def gelu_plain(v: torch.Tensor, variant: str) -> torch.Tensor:
    """The three GELU flavours of the JAX package's ``_gelu``."""
    if variant == "tanh":
        return torch.nn.functional.gelu(v, approximate="tanh")
    if variant == "sigmoid":
        return v * torch.sigmoid(1.702 * v)
    return torch.nn.functional.gelu(v)


def _gelu_grad(v: torch.Tensor, variant: str) -> torch.Tensor:
    """d gelu(v) / dv for each variant (f32)."""
    if variant == "tanh":
        u = _SQRT_2_OVER_PI * (v + 0.044715 * v * v * v)
        th = torch.tanh(u)
        du = _SQRT_2_OVER_PI * (1.0 + 3.0 * 0.044715 * v * v)
        return 0.5 * (1.0 + th) + 0.5 * v * (1.0 - th * th) * du
    if variant == "sigmoid":
        s = torch.sigmoid(1.702 * v)
        return s + 1.702 * v * s * (1.0 - s)
    Phi = 0.5 * (1.0 + torch.erf(v * (1.0 / math.sqrt(2.0))))
    phi = torch.exp(-0.5 * v * v) * _INV_SQRT2PI
    return Phi + v * phi


def fused_plain(x: torch.Tensor, inv: torch.Tensor, mod: torch.Tensor,
                gelu: str) -> torch.Tensor:
    """Plain torch version of the kernel: x [B, R, C]; inv, mod [B, C] f32."""
    s = (inv * mod)[:, None, :]
    return gelu_plain(x.float() * s, gelu).to(x.dtype)


# ----------------------------------------------------------------- kernel

_KERNEL = None


def _build_kernel():
    """Define the Triton kernel on first CUDA use (``triton`` is absent on
    CPU-only installs, and tests import this module)."""
    global _KERNEL
    if _KERNEL is not None:
        return _KERNEL
    import triton
    import triton.language as tl

    @triton.jit
    def _fused_adaln_fwd(x_ptr, inv_ptr, mod_ptr, y_ptr, R, C,
                         BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr,
                         GELU: tl.constexpr):
        pid_r = tl.program_id(0)
        b = tl.program_id(1)
        cols = tl.arange(0, BLOCK_C)
        cmask = cols < C
        # the batch row's [C] scale, loaded once per program
        inv = tl.load(inv_ptr + b * C + cols, mask=cmask, other=0.0)
        mod = tl.load(mod_ptr + b * C + cols, mask=cmask, other=0.0)
        s = (inv * mod)[None, :]
        rows = pid_r * BLOCK_R + tl.arange(0, BLOCK_R)
        base = b.to(tl.int64) * R * C
        offs = base + rows[:, None].to(tl.int64) * C + cols[None, :]
        m = (rows[:, None] < R) & cmask[None, :]
        v = tl.load(x_ptr + offs, mask=m, other=0.0).to(tl.float32) * s
        if GELU == 0:      # erf
            y = 0.5 * v * (1.0 + tl.erf(v * 0.7071067811865476))
        elif GELU == 1:    # tanh approximation; tanh(u) = 2 sigmoid(2u) - 1
            u = 0.7978845608028654 * (v + 0.044715 * v * v * v)
            y = v * tl.sigmoid(2.0 * u)
        else:              # sigmoid approximation
            y = v * tl.sigmoid(1.702 * v)
        tl.store(y_ptr + offs, y.to(y_ptr.dtype.element_ty), mask=m)

    _KERNEL = _fused_adaln_fwd
    return _KERNEL


def _tile(C: int):
    block_c = 1 << max(0, (C - 1).bit_length())
    block_r = max(1, 8192 // block_c)
    return block_r, block_c


def _fused_cuda(x: torch.Tensor, inv: torch.Tensor, mod: torch.Tensor,
                gelu: str) -> torch.Tensor:
    global _launches, _captured
    kernel = _build_kernel()
    B, R, C = x.shape
    y = torch.empty_like(x)
    block_r, block_c = _tile(C)
    grid = ((R + block_r - 1) // block_r, B)
    kernel[grid](x, inv, mod, y, R, C, BLOCK_R=block_r, BLOCK_C=block_c,
                 GELU=GELU_VARIANTS.index(gelu), num_warps=8)
    if torch.cuda.is_current_stream_capturing():
        _captured += 1
    else:
        _launches += 1
    return y


def _fused_forward(x, inv, mod, gelu):
    if x.device.type == "cuda":
        return _fused_cuda(x, inv, mod, gelu)
    if x.device.type == "cpu":
        return fused_plain(x, inv, mod, gelu)
    raise ValueError(f"fused_adaln: unsupported device {x.device}")


class _Fused(torch.autograd.Function):
    """y = gelu(x * inv * mod); forward through the kernel (or the plain
    version on CPU), backward in plain torch: dx = g gelu'(v) s and the
    table gradients are row sums."""

    @staticmethod
    def forward(ctx, x, inv, mod, gelu):
        ctx.save_for_backward(x, inv, mod)
        ctx.gelu = gelu
        return _fused_forward(x, inv, mod, gelu)

    @staticmethod
    def backward(ctx, g):
        x, inv, mod = ctx.saved_tensors
        xf = x.float()
        s = (inv * mod)[:, None, :]
        v = xf * s
        dv = g.float() * _gelu_grad(v, ctx.gelu)
        dx = (dv * s).to(x.dtype) if ctx.needs_input_grad[0] else None
        dinv = ((dv * xf).sum(1) * mod if ctx.needs_input_grad[1] else None)
        dmod = ((dv * xf).sum(1) * inv if ctx.needs_input_grad[2] else None)
        return dx, dinv, dmod, None


def _check(x: torch.Tensor, std: torch.Tensor, gamma: torch.Tensor,
           aff: torch.Tensor, num_groups: int, gelu: str) -> None:
    if gelu not in GELU_VARIANTS:
        raise ValueError(f"gelu must be one of {GELU_VARIANTS}, got {gelu!r}")
    if x.dim() != 4:
        raise ValueError(f"x must be [B, F, T, C], got shape {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    B, _, _, C = x.shape
    if C % num_groups:
        raise ValueError(f"C={C} is not divisible by {num_groups} groups")
    if tuple(std.shape) != (B, num_groups) or tuple(gamma.shape) != (C,) \
            or tuple(aff.shape) != (B, C):
        raise ValueError(
            f"table shapes std {tuple(std.shape)}, gamma {tuple(gamma.shape)}, "
            f"aff {tuple(aff.shape)} do not fit x {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous with C innermost "
                         f"(strides {x.stride()})")
    for name, t in (("std", std), ("gamma", gamma), ("aff", aff)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def norm_adaln_gelu(x: torch.Tensor, std: torch.Tensor, gamma: torch.Tensor,
                    aff: torch.Tensor, eps: float, num_groups: int,
                    gelu: str = "erf") -> torch.Tensor:
    """gelu(x / (std + eps) * gamma * (1 + aff)) in one activation pass.

    x:     [B, F, T, C] contiguous (channels last), f32 or bf16
    std:   [B, G]   per-(batch, group) Bessel-corrected std (``group_std``)
    gamma: [C]      norm gain
    aff:   [B, C]   adaLN affine(emb)
    Returns [B, F, T, C] in x's dtype. Differentiable in all four tensors.
    """
    _check(x, std, gamma, aff, num_groups, gelu)
    B, F, T, C = x.shape
    G = num_groups
    inv = (gamma.float().reshape(1, G, C // G)
           / (std.float()[:, :, None] + eps)).reshape(B, C).contiguous()
    mod = (1.0 + aff.float()).contiguous()
    y = _Fused.apply(x.reshape(B, F * T, C), inv, mod, gelu)
    return y.reshape(B, F, T, C)


def norm_adaln_gelu_plain(x: torch.Tensor, std: torch.Tensor,
                          gamma: torch.Tensor, aff: torch.Tensor, eps: float,
                          num_groups: int, gelu: str = "erf") -> torch.Tensor:
    """The same function composed of plain torch ops (autograd throughout)."""
    _check(x, std, gamma, aff, num_groups, gelu)
    B, F, T, C = x.shape
    G = num_groups
    inv = (gamma.float().reshape(1, G, C // G)
           / (std.float()[:, :, None] + eps)).reshape(B, 1, 1, C)
    mod = (1.0 + aff.float()).reshape(B, 1, 1, C)
    return gelu_plain(x.float() * (inv * mod), gelu).to(x.dtype)


def group_std(x: torch.Tensor, num_groups: int, cp=None) -> torch.Tensor:
    """Bessel-corrected std over (F, T, C/G) per (batch, group), reduced in
    f32 with the one-pass moments max(m2 - m1^2, 0) * n / (n - 1).
    x [B, F, T, C] -> [B, G] f32.

    ``cp`` (``parallel.cp.ContextParallel``): x is this rank's block of a
    time axis split over equal blocks; the local moments are averaged over
    the group by an autograd all-reduce (its backward sums the partial
    gradients) and n counts the whole axis, as the JAX package's GSPMD
    reduction does."""
    B, F, T, C = x.shape
    G = num_groups
    xf = x.float().reshape(B, F * T, G, C // G)
    n = F * T * (C // G)
    m1 = xf.mean(dim=(1, 3))
    m2 = xf.square().mean(dim=(1, 3))
    if cp is not None:
        m1, m2 = (cp.all_reduce(torch.stack([m1, m2])) / cp.n).unbind(0)
        n *= cp.n
    var = torch.clamp_min(m2 - m1 * m1, 0.0) * (n / (n - 1.0))
    return var.sqrt()
