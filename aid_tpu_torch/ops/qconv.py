"""Dynamic int8 conv and dot for serving (port of ``aid_tpu/ops/qconv.py``).

    fwd:  y  = conv(q8(x), q8_oc(w)) * (sx * sw)    per-sample x (dynamic),
                                                    per-out-channel w
    bwd:  dx = conv(q8(g), q8_oc(rot180(w)^T)) * .. the same scheme

int8 x int8 products are summed exactly in int32 (``torch._int_mm``), then
dequantized by ``sx * sw`` in f32 and cast to x's dtype, in the JAX
package's order, so on the same inputs both give the same bits. The weight
cotangent is zero: this path is inference-only (the trainer refuses a
quantized network, because a zero weight gradient would freeze learning).

Compute route: a dot is one ``_int_mm`` over the flattened rows; a conv
folds its frequency dilation into the batch (row f = q d + r is row q of
phase r, as ``models.unet_cqt.Conv2dFT``), pads, and takes an int8 im2col
of the folded layout into one ``_int_mm``. ``_int_mm`` on CUDA wants more
than 16 rows and K and N divisible by 8: rows, K and N are padded with
zeros on every device, which leaves the int32 sums exact.

Under full-score context parallelism (``group``) a sample's time axis is
split over ranks: its scale is the max over the whole sample, all-reduced
over the group, as GSPMD reduces it in the JAX package.

The JAX ``AID_TPU_QUANT`` environment override is a TPU A/B switch; the
port reads ``network.quant`` only.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

_EPS = 1e-12


def quant_tensor(x: torch.Tensor, group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample (leading-axis) symmetric int8: (q, scale [B, 1, ..., 1]).
    Each batch row's quantization is independent of its batchmates, so a
    served result does not change with batch composition."""
    xf = x.float()
    s = xf.abs().amax(dim=tuple(range(1, x.dim())), keepdim=True)
    if group is not None:
        dist.all_reduce(s, op=dist.ReduceOp.MAX, group=group)
    s = torch.clamp_min(s / 127.0, _EPS)
    q = torch.clamp(torch.round(xf / s), -127, 127)
    return q.to(torch.int8), s


def quant_per_out_channel(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 over dim 0 of an OIHW (or [O, I])
    weight: (q, scale [O])."""
    wf = w.float()
    s = torch.clamp_min(wf.abs().amax(dim=tuple(range(1, w.dim()))) / 127.0, _EPS)
    q = torch.clamp(torch.round(wf / s.reshape(-1, *([1] * (w.dim() - 1)))), -127, 127)
    return q.to(torch.int8), s


class QWeight(NamedTuple):
    """An OIHW conv kernel quantized once (load time): ``q``/``s`` the
    forward kernel per out channel, ``qt``/``st`` the spatially rotated,
    channel-transposed kernel the input cotangent needs, quantized on its
    own out channels."""
    q: torch.Tensor    # int8 [O, I, kh, kw]
    s: torch.Tensor    # f32  [O]
    qt: torch.Tensor   # int8 [I, O, kh, kw]
    st: torch.Tensor   # f32  [I]


def _rotated(w: torch.Tensor) -> torch.Tensor:
    return w.flip(2, 3).transpose(0, 1)


def prequantize_kernel(w: torch.Tensor, dtype: torch.dtype = torch.bfloat16) -> QWeight:
    """QWeight of an OIHW kernel, bit-identical to the dynamic path (which
    quantizes after the compute-dtype cast)."""
    wc = w.detach().to(dtype)
    q, s = quant_per_out_channel(wc)
    qt, st = quant_per_out_channel(_rotated(wc))
    return QWeight(q, s, qt, st)


def dequantize_kernel(qw: QWeight, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    return (qw.q.float() * qw.s.reshape(-1, 1, 1, 1)).to(dtype)


def prequant_eligible(weight: torch.Tensor) -> bool:
    """1x1 kernels, and spatial kernels with more than 64 input channels
    (the JAX package keeps the narrow spatial ones dense for its folded
    layouts; the port follows the same rule)."""
    _, cin, kh, kw = weight.shape
    return (kh, kw) == (1, 1) or cin > 64


def prequantize_params(module, dtype: torch.dtype = torch.bfloat16) -> int:
    """Quantize every eligible int8 conv kernel of ``module`` now (they
    are otherwise quantized at their first use after each weight load);
    returns how many."""
    n = 0
    for m in module.modules():
        if (hasattr(m, "qweight") and m.quant == "int8"
                and prequant_eligible(m.weight)):
            m.qweight(dtype)
            n += 1
    return n


# --------------------------------------------------------------- int8 matmul


def _round_up(v: int, k: int) -> int:
    return -(-v // k) * k


def int8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] int8 @ b [K, N] int8 -> [M, N] int32, summed exactly."""
    M, K = a.shape
    N = b.shape[1]
    Mp, Kp, Np = max(M, 17), _round_up(K, 8), _round_up(N, 8)
    if (Mp, Kp) != (M, K):
        a = F.pad(a, (0, Kp - K, 0, Mp - M))
    if (Kp, Np) != (K, N):
        b = F.pad(b, (0, Np - N, 0, Kp - K))
    return torch._int_mm(a.contiguous(), b.contiguous())[:M, :N]


def _conv_int(xq: torch.Tensor, wq: torch.Tensor, d: int,
              tpad: int) -> torch.Tensor:
    """Integer conv of int8 x [B, F, T, C] with int8 OIHW w: frequency
    dilation d with SAME padding, time padding ``tpad`` on each side;
    returns int32 [B, F, T + 2 tpad - kw + 1, O]."""
    O, C, kh, kw = wq.shape
    B, F_, T, _ = xq.shape
    q = -(-F_ // d)
    if q * d != F_:                      # zero rows are SAME padding
        xq = F.pad(xq, (0, 0, 0, 0, 0, q * d - F_))
    if d > 1:
        xq = xq.reshape(B, q, d, T, C).transpose(1, 2).reshape(B * d, q, T, C)
    xq = F.pad(xq, (0, 0, tpad, tpad, kh // 2, kh // 2))
    cols = xq.unfold(1, kh, 1).unfold(2, kw, 1)          # [Bd, q, To, C, kh, kw]
    Bd, _, To = cols.shape[:3]
    cols = cols.permute(0, 1, 2, 4, 5, 3).reshape(Bd * q * To, kh * kw * C)
    y = int8_mm(cols, wq.permute(2, 3, 1, 0).reshape(kh * kw * C, O))
    y = y.reshape(Bd, q, To, O)
    if d > 1:
        y = y.reshape(B, d, q, To, O).transpose(1, 2).reshape(B, q * d, To, O)
    return y[:, :F_]


def _qconv_apply(x, wq, sw, d, tpad, group):
    xq, sx = quant_tensor(x, group)
    y = _conv_int(xq, wq, d, tpad)
    return (y.float() * (sx * sw)).to(x.dtype)


def _qdot_apply(x, wq, sw, group):
    """x [..., C] @ wq^T for an int8 [N, C] weight."""
    xq, sx = quant_tensor(x, group)
    y = int8_mm(xq.reshape(-1, xq.shape[-1]), wq.t()).reshape(*x.shape[:-1], -1)
    return (y.float() * (sx * sw)).to(x.dtype)


class _QConv(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, qw, d, tpad, group):
        if qw is None:
            wq, sw = quant_per_out_channel(w)
        else:
            wq, sw = qw.q, qw.s
        ctx.qw, ctx.d, ctx.group = qw, d, group
        ctx.tpad = w.shape[3] - 1 - tpad          # the transposed conv's padding
        ctx.save_for_backward(w)
        return _qconv_apply(x, wq, sw, d, tpad, group)

    @staticmethod
    def backward(ctx, g):
        (w,) = ctx.saved_tensors
        if ctx.qw is None:
            wtq, stq = quant_per_out_channel(_rotated(w))
        else:
            wtq, stq = ctx.qw.qt, ctx.qw.st
        dx = _qconv_apply(g, wtq, stq, ctx.d, ctx.tpad, ctx.group)
        return dx, torch.zeros_like(w), None, None, None, None


class _QDot(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, qw, group):
        if qw is None:
            wq, sw = quant_per_out_channel(w)
        else:
            wq, sw = qw.q[:, :, 0, 0], qw.s
        ctx.qw, ctx.group = qw, group
        ctx.save_for_backward(w)
        return _qdot_apply(x, wq, sw, group)

    @staticmethod
    def backward(ctx, g):
        (w,) = ctx.saved_tensors
        if ctx.qw is None:
            wtq, stq = quant_per_out_channel(w.t())
        else:
            wtq, stq = ctx.qw.qt[:, :, 0, 0], ctx.qw.st
        dx = _qdot_apply(g, wtq, stq, ctx.group)
        return dx, torch.zeros_like(w), None, None


def qconv(x: torch.Tensor, w: torch.Tensor, dilation: int = 1, qw: Optional[QWeight] = None,
          tpad: Optional[int] = None, group=None) -> torch.Tensor:
    """Stride-1 int8 conv of channels-last x [B, F, T, C] with an OIHW
    kernel w in x's dtype: frequency dilation ``dilation`` with SAME
    padding; time padding ``tpad`` (SAME when None; 0 when a halo was
    added, ``parallel.cp``). ``qw`` is w prequantized (``prequantize_kernel``,
    the same bits) or None to quantize w now. Odd kernel dims (every conv of
    the model is (5, 3) or (1, 1)), so the input cotangent is the conv of
    the output cotangent with the rotated, transposed kernel."""
    kw = w.shape[3]
    return _QConv.apply(x, w, qw, int(dilation), kw // 2 if tpad is None else int(tpad), group)


def qdot(x: torch.Tensor, w: torch.Tensor, qw: Optional[QWeight] = None,
         group=None) -> torch.Tensor:
    """x [..., C] @ w.T in int8 for an [N, C] weight in x's dtype (the 1x1
    conv as a matmul); ``qw`` a (1, 1) QWeight of it, or None."""
    return _QDot.apply(x, w, qw, group)
