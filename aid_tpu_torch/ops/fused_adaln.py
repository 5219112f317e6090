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

The backward, ``_fused_adaln_bwd`` (Triton), replaces no TPU kernel: the JAX
backward is plain XLA, which fuses it into a few passes by itself, while
PyTorch runs the same plain backward as ~25 full-size f32 elementwise passes
(~240 bytes of traffic an element). For ``v = x * s``, ``s = inv * mod``, it
computes ``dv = g * gelu'(v)``, writes ``dx = dv * s`` in x's dtype, and
reduces ``q = sum_rows(dv * x)`` in f32, from which ``dinv = q * mod`` and
``dmod = q * inv``. It is bound by HBM bytes too: one read of ``x`` and ``g``
and one write of ``dx``, ``3 * bytes(x)`` per launch. Each program owns whole
rows of one batch entry, loops over ``TILES`` contiguous row tiles with the
batch row's scale in registers, keeps its ``dv * x`` sums in f32 registers
across the loop, and writes one ``[C]`` partial into a ``[B, P, C]`` scratch
buffer; a torch sum over ``P`` finishes the reduction. No atomics: the sums
are taken in one fixed order, so a run, and a CUDA graph's replay of it, is
bit-identical to the next. The tile (rows per tile, programs per batch row,
warps) is chosen from the shape and dtype (``_bwd_tile``); the variants are
compiled per dtype, GELU variant, column block and which gradients are
needed, nothing else.

Dispatch, both directions: a CPU tensor takes the plain version; a CUDA
tensor launches the kernel or raises. ``triton`` is imported inside the
CUDA branch only.
"""
from __future__ import annotations

import math

import torch

from aid_tpu_torch.utils import trace

GELU_VARIANTS = ("erf", "tanh", "sigmoid")
_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)
_INV_SQRT2PI = 1.0 / math.sqrt(2.0 * math.pi)

# Launches of the Triton kernels, the forward's and the backward's apart
# (``trace.Launches``: a capture's launches counted apart, added by each
# replay). The forward's count stays the forward's alone: the benchmark
# divides the forward's bytes by it.
LAUNCHES = trace.Launches("fused_adaln")


def launch_count() -> int:
    """Forward kernel launches."""
    return LAUNCHES.count()


def bwd_launch_count() -> int:
    """Backward kernel launches."""
    return LAUNCHES.count(bwd=True)


def reset_launch_count() -> None:
    """Zero both launch counts."""
    LAUNCHES.reset()


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


def fused_bwd_plain(x: torch.Tensor, g: torch.Tensor, inv: torch.Tensor,
                    mod: torch.Tensor, gelu: str, need_dx: bool = True,
                    need_q: bool = True):
    """Plain torch version of the backward kernel: (dx in x's dtype, or None;
    q = sum over rows of dv * x [B, C] f32, or None) for y = gelu(x * s)."""
    xf = x.float()
    s = (inv * mod)[:, None, :]
    dv = g.float() * _gelu_grad(xf * s, gelu)
    dx = (dv * s).to(x.dtype) if need_dx else None
    q = (dv * xf).sum(1) if need_q else None
    return dx, q


# ----------------------------------------------------------------- kernel

_KERNEL = None
_BWD_KERNEL = None


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


def _build_bwd_kernel():
    """Define the backward Triton kernel on first CUDA use."""
    global _BWD_KERNEL
    if _BWD_KERNEL is not None:
        return _BWD_KERNEL
    import triton
    import triton.language as tl

    @triton.jit(do_not_specialize=["R", "TILES"])
    def _fused_adaln_bwd(x_ptr, g_ptr, inv_ptr, mod_ptr, dx_ptr, q_ptr, R, C, TILES,
                         BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr,
                         GELU: tl.constexpr, NEED_DX: tl.constexpr,
                         NEED_Q: tl.constexpr):
        pid = tl.program_id(0)
        b = tl.program_id(1)
        cols = tl.arange(0, BLOCK_C)
        cmask = cols < C
        # the batch row's [C] scale, loaded once per program
        inv = tl.load(inv_ptr + b * C + cols, mask=cmask, other=0.0)
        mod = tl.load(mod_ptr + b * C + cols, mask=cmask, other=0.0)
        s = (inv * mod)[None, :]
        r = tl.arange(0, BLOCK_R)
        offs = r[:, None] * C + cols[None, :]          # within a tile, int32
        acc = tl.zeros((BLOCK_R, BLOCK_C), dtype=tl.float32)
        row0 = pid * TILES * BLOCK_R
        for t in range(0, TILES):
            start = row0 + t * BLOCK_R
            base = (b.to(tl.int64) * R + start) * C
            m = ((start + r)[:, None] < R) & cmask[None, :]
            x = tl.load(x_ptr + base + offs, mask=m, other=0.0).to(tl.float32)
            g = tl.load(g_ptr + base + offs, mask=m, other=0.0).to(tl.float32)
            v = x * s
            if GELU == 0:      # erf: Phi(v) + v phi(v)
                d = (0.5 * (1.0 + tl.erf(v * 0.7071067811865476))
                     + v * tl.exp(-0.5 * v * v) * 0.3989422804014327)
            elif GELU == 1:    # tanh: 0.5 (1 + th) = sg, 1 - th^2 = 4 sg (1 - sg)
                u = 0.7978845608028654 * (v + 0.044715 * v * v * v)
                # sg = sigmoid(2u) and sg (1 - sg) = e / (1 + e)^2 from
                # e = exp(-2|u|), with no 1 - sg that cancels in either tail
                e = tl.exp(-2.0 * tl.abs(u))
                w = 1.0 / (1.0 + e)
                sg = tl.where(u >= 0.0, w, e * w)
                du = 0.7978845608028654 * (1.0 + 0.134145 * v * v)
                d = sg + 2.0 * v * du * (e * w * w)
            else:              # sigmoid approximation, the same way
                e = tl.exp(-1.702 * tl.abs(v))
                w = 1.0 / (1.0 + e)
                d = tl.where(v >= 0.0, w, e * w) + 1.702 * v * (e * w * w)
            dv = g * d
            if NEED_DX:
                tl.store(dx_ptr + base + offs, (dv * s).to(dx_ptr.dtype.element_ty), mask=m)
            if NEED_Q:
                acc += dv * x
        if NEED_Q:
            q = tl.sum(acc, axis=0)
            tl.store(q_ptr + (b * tl.num_programs(0) + pid) * C + cols, q, mask=cmask)

    _BWD_KERNEL = _fused_adaln_bwd
    return _BWD_KERNEL


def _tile(C: int):
    block_c = 1 << max(0, (C - 1).bit_length())
    block_r = max(1, 8192 // block_c)
    return block_r, block_c


# The backward's tile: 16 KiB of x a tile (64 bytes a thread of each tensor
# in and out at 8 warps), and programs enough for two per SM of the card's
# 132 across the batch: the best of a sweep of 2-8K elements, 4-8 warps and
# 1-8 programs an SM at the flagships' shapes on an H100.
_BWD_TILE_BYTES = 16384
_BWD_WARPS = 8
_BWD_PROGRAMS = 264


def _bwd_tile(B: int, R: int, C: int, itemsize: int):
    """(BLOCK_R, BLOCK_C, row tiles a program, programs a batch row, warps)
    for x [B, R, C]: a fixed function of the shape and dtype, so the
    partial sums, and their order, are too."""
    block_c = 1 << max(0, (C - 1).bit_length())
    block_r = max(1, _BWD_TILE_BYTES // itemsize // block_c)
    tiles = -(-R // block_r)
    per_prog = -(-tiles // max(1, _BWD_PROGRAMS // B))
    return block_r, block_c, per_prog, -(-tiles // per_prog), _BWD_WARPS


def _fused_cuda(x: torch.Tensor, inv: torch.Tensor, mod: torch.Tensor,
                gelu: str) -> torch.Tensor:
    kernel = _build_kernel()
    B, R, C = x.shape
    y = torch.empty_like(x)
    block_r, block_c = _tile(C)
    grid = ((R + block_r - 1) // block_r, B)
    kernel[grid](x, inv, mod, y, R, C, BLOCK_R=block_r, BLOCK_C=block_c,
                 GELU=GELU_VARIANTS.index(gelu), num_warps=8)
    LAUNCHES.launched()
    return y


def _fused_bwd_cuda(x: torch.Tensor, g: torch.Tensor, inv: torch.Tensor,
                    mod: torch.Tensor, gelu: str, need_dx: bool = True,
                    need_q: bool = True):
    """The backward kernel: as ``fused_bwd_plain``."""
    kernel = _build_bwd_kernel()
    B, R, C = x.shape
    g = g.contiguous()
    block_r, block_c, per_prog, P, warps = _bwd_tile(B, R, C, x.element_size())
    dx = torch.empty_like(x) if need_dx else None
    part = torch.empty((B, P, C), dtype=torch.float32, device=x.device) if need_q else None
    kernel[(P, B)](x, g, inv, mod, x if dx is None else dx, inv if part is None else part,
                   R, C, per_prog, BLOCK_R=block_r, BLOCK_C=block_c,
                   GELU=GELU_VARIANTS.index(gelu), NEED_DX=need_dx, NEED_Q=need_q,
                   num_warps=warps)
    LAUNCHES.launched(bwd=True)
    return dx, (part.sum(1) if need_q else None)


def _fused_forward(x, inv, mod, gelu):
    if x.device.type == "cuda":
        return _fused_cuda(x, inv, mod, gelu)
    if x.device.type == "cpu":
        return fused_plain(x, inv, mod, gelu)
    raise ValueError(f"fused_adaln: unsupported device {x.device}")


def _fused_backward(x, g, inv, mod, gelu, need_dx, need_q):
    if x.device.type == "cuda":
        return _fused_bwd_cuda(x, g, inv, mod, gelu, need_dx, need_q)
    if x.device.type == "cpu":
        return fused_bwd_plain(x, g, inv, mod, gelu, need_dx, need_q)
    raise ValueError(f"fused_adaln: unsupported device {x.device}")


class _Fused(torch.autograd.Function):
    """y = gelu(x * inv * mod), forward and backward through the kernels (or
    their plain versions on CPU): dx = g gelu'(v) s, and the table gradients
    come from one row sum q = sum_rows(g gelu'(v) x)."""

    @staticmethod
    def forward(ctx, x, inv, mod, gelu):
        ctx.save_for_backward(x, inv, mod)
        ctx.gelu = gelu
        return _fused_forward(x, inv, mod, gelu)

    @staticmethod
    def backward(ctx, g):
        x, inv, mod = ctx.saved_tensors
        need_dx, need_inv, need_mod = ctx.needs_input_grad[:3]
        dx, q = _fused_backward(x, g, inv, mod, ctx.gelu, need_dx, need_inv or need_mod)
        return (dx, q * mod if need_inv else None, q * inv if need_mod else None, None)


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
