"""Octave-CQT U-Net denoiser in PyTorch (plain formulation).

Port of ``aid_tpu/models/unet_cqt.py``. Activations are held channels-last,
``[B, F, T, C]``, as in the JAX package: the fused norm x adaLN x GELU
kernel reads C innermost, a 1x1 conv is a matmul over the last axis, and a
(5, 3) conv sees the permuted ``[B, C, F, T]`` view, which is an NCHW tensor
in ``torch.channels_last`` memory format, so cuDNN runs it without copies.

Modules and parameters carry the state-dict names of the reference PyTorch
network (``downs.{i}.0/1/2``, ``middle.{m}.0/1``, ``ups.{j}.0/1``, ``H.{k}``,
``norm.{k}.gamma``, ``affine.{k}``, ``gate.{k}``, ``attn_block.*``,
``embedding.MLP.*``), so a released state dict loads with ``load_state_dict``.

Parameters are stored in f32; every op casts them to ``dtype`` (the compute
dtype). Norm statistics, the fused kernel's math and the attention softmax
run in f32; the decoder's coefficients and the output are f32.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from aid_tpu_torch.ops import fused_adaln
from aid_tpu_torch.ops.cqt import CQT, get_cqt

SQRT2 = math.sqrt(2.0)
MAIN_SCALE = math.sqrt(1.0 / 3.0)   # kaiming-uniform x sqrt(1/3), as the reference
GATE_SCALE = 1e-7                   # zero-ish gates at init, as the reference


def _uniform_(w: torch.Tensor, fan_in: int, scale: float, gen: torch.Generator):
    bound = math.sqrt(3.0 / fan_in) * scale
    with torch.no_grad():
        w.copy_(torch.rand(w.shape, generator=gen) * (2 * bound) - bound)


class Linear(nn.Linear):
    """nn.Linear applied in the compute dtype."""

    def __init__(self, in_features: int, out_features: int, gate: bool = False):
        super().__init__(in_features, out_features)
        self.gate = gate

    def reset(self, gen: torch.Generator, gate_scale: float = GATE_SCALE):
        s = gate_scale if self.gate else MAIN_SCALE
        _uniform_(self.weight, self.in_features, s, gen)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)


class Conv2dFT(nn.Module):
    """Bias-free conv over (F, T) with frequency dilation; x [B, F, T, C].

    1x1: a matmul over C. Otherwise a SAME-padded ``conv2d`` on the
    channels-last NCHW view. A frequency dilation d > 1 is folded into the
    batch: row f = q d + r is row q of phase r, so the conv runs undilated
    on d phases of F/d rows each. cuDNN has no fast channels-last kernel for
    some dilated shapes (on an H100 with cuDNN 9.2, C=256 at dilation >= 8
    took 50-105 ms a call, see PERF.md); the folded conv is an ordinary one.
    ``weight`` is OIHW, as in the reference."""

    def __init__(self, in_ch: int, out_ch: int, kernel=(1, 1), dilation=(1, 1)):
        super().__init__()
        self.kernel = tuple(kernel)
        self.dilation = tuple(dilation)
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, *self.kernel))

    def reset(self, gen: torch.Generator, gate_scale: float = GATE_SCALE):
        kh, kw = self.kernel
        _uniform_(self.weight, self.weight.shape[1] * kh * kw, MAIN_SCALE, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(x.dtype)
        if self.kernel == (1, 1) and self.dilation == (1, 1):
            return torch.matmul(x, w[:, :, 0, 0].t())
        kh, kw = self.kernel
        d = self.dilation[0]
        if self.dilation[1] != 1:
            raise NotImplementedError("Conv2dFT dilates frequency only")
        B, F_, T, C = x.shape
        q = -(-F_ // d)                      # rows per phase
        if q * d != F_:                      # zero rows are SAME padding
            x = F.pad(x, (0, 0, 0, 0, 0, q * d - F_))
        if d > 1:
            x = x.reshape(B, q, d, T, C).transpose(1, 2).reshape(B * d, q, T, C)
        y = F.conv2d(x.permute(0, 3, 1, 2), w, padding=(kh // 2, kw // 2))
        y = y.permute(0, 2, 3, 1)            # [B d, q, T, O]
        if d > 1:
            y = y.reshape(B, d, q, T, -1).transpose(1, 2).reshape(B, q * d, T, -1)
        return y[:, :F_]


class NormGain(nn.Module):
    """Owner of a bias-free group norm's gain (``gamma`` [1, N, 1, 1])."""

    def __init__(self, n: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(1, n, 1, 1))

    def reset(self, gen: torch.Generator, gate_scale: float = GATE_SCALE):
        with torch.no_grad():
            self.gamma.fill_(1.0)

    def forward(self) -> torch.Tensor:
        return self.gamma.reshape(-1)


def _norm_adaln_scale(x: torch.Tensor, gain: torch.Tensor, aff: torch.Tensor,
                      eps: float = 1e-7, groups: int = 8) -> torch.Tensor:
    """x * (gain / (std + eps)) * (1 + aff), with the f32 one-pass group std
    (the attention sub-block's norm; no GELU follows it)."""
    B, F_, T, C = x.shape
    g = min(groups, C)
    std = fused_adaln.group_std(x, g)
    mult = (gain.float().reshape(1, g, C // g) / (std[:, :, None] + eps)).reshape(B, C)
    mult = mult * (1.0 + aff.float())
    return x * mult[:, None, None, :].to(x.dtype)


class RFFEmbedding(nn.Module):
    """Noise-level embedding: frozen random Fourier features + 3-layer ReLU MLP."""

    def __init__(self, emb_dim: int = 256, rff_dim: int = 32):
        super().__init__()
        self.RFF_freq = nn.Parameter(torch.empty(1, rff_dim), requires_grad=False)
        self.MLP = nn.ModuleList([Linear(2 * rff_dim, 128), Linear(128, 256),
                                  Linear(256, emb_dim)])

    def reset(self, gen: torch.Generator, gate_scale: float = GATE_SCALE):
        with torch.no_grad():
            self.RFF_freq.copy_(16.0 * torch.randn(self.RFF_freq.shape, generator=gen))

    def forward(self, cnoise: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        table = 2.0 * math.pi * cnoise.float() * self.RFF_freq
        x = torch.cat([torch.sin(table), torch.cos(table)], dim=-1).to(dtype)
        for lin in self.MLP:
            x = torch.relu(lin(x))
        return x


class RelPositionBias(nn.Module):
    """T5-style bucketed relative position bias."""

    def __init__(self, num_buckets: int, max_distance: int, num_heads: int):
        super().__init__()
        self.num_buckets = num_buckets
        self.max_distance = max_distance
        self.relative_attention_bias = nn.Embedding(num_buckets, num_heads)

    def reset(self, gen: torch.Generator, gate_scale: float = GATE_SCALE):
        w = self.relative_attention_bias.weight
        with torch.no_grad():
            w.copy_(torch.randn(w.shape, generator=gen))

    def forward(self, n_q: int, n_k: int, device) -> torch.Tensor:
        q_pos = torch.arange(n_k - n_q, n_k, device=device)
        k_pos = torch.arange(n_k, device=device)
        rel = k_pos[None, :] - q_pos[:, None]
        nb = self.num_buckets // 2
        ret = (rel >= 0).long() * nb
        n = rel.abs()
        max_exact = nb // 2
        val_large = max_exact + (
            torch.log(n.clamp(min=1).float() / max_exact)
            / math.log(self.max_distance / max_exact) * (nb - max_exact)).long()
        val_large = val_large.clamp(max=nb - 1)
        buckets = ret + torch.where(n < max_exact, n, val_large)
        bias = self.relative_attention_bias.weight[buckets]   # [Tq, Tk, H]
        return bias.permute(2, 0, 1)[None].float()            # [1, H, Tq, Tk]


class TimeAttention(nn.Module):
    """Projection attention along time: channels collapse to ``num_heads``
    through a 1x1 conv, frequency folds into the head feature dim (F), V is
    that projection itself. QK^T, the bias and the softmax run in f32, the
    bias added before the F^-0.5 scale."""

    def __init__(self, channels: int, fdim: int, num_heads: int = 8,
                 bias_qkv: bool = False, use_rel_pos: bool = False,
                 rel_pos_num_buckets: int = 32, rel_pos_max_distance: int = 64):
        super().__init__()
        H = num_heads
        self.num_heads = H
        self.fdim = fdim
        self.proj_in = Conv2dFT(channels, H)
        self.proj_out = Conv2dFT(H, channels)
        self.qk = _QK(H * fdim, bias_qkv)
        self.rel_pos = (RelPositionBias(rel_pos_num_buckets, rel_pos_max_distance, H)
                        if use_rel_pos else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, F_, T, C = x.shape
        H = self.num_heads
        h = self.proj_in(x)                                       # [B, F, T, H]
        z = h.permute(0, 2, 3, 1).reshape(B, T, H * F_)           # [B, T, (h f)]
        v = z.reshape(B, T, H, F_).permute(0, 2, 1, 3)            # [B, H, T, F]
        qk = self.qk(z).reshape(B, T, H, 2 * F_).permute(0, 2, 1, 3)
        q, k = qk.split(F_, dim=-1)
        sim = torch.matmul(q.float(), k.float().transpose(-1, -2))
        if self.rel_pos is not None:
            sim = sim + self.rel_pos(T, T, x.device)
        attn = torch.softmax(sim * (float(F_) ** -0.5), dim=-1).to(x.dtype)
        out = torch.matmul(attn, v)                               # [B, H, T, F]
        return self.proj_out(out.permute(0, 3, 2, 1))             # [B, F, T, C]


class _QK(nn.Module):
    """The reference's qk Conv1d (``weight`` [2HF, HF, 1]) as a matmul."""

    def __init__(self, hf: int, bias: bool):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(2 * hf, hf, 1))
        self.bias = nn.Parameter(torch.zeros(2 * hf)) if bias else None

    def reset(self, gen: torch.Generator, gate_scale: float = GATE_SCALE):
        _uniform_(self.weight, self.weight.shape[1], MAIN_SCALE, gen)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(z.dtype)
        return F.linear(z, self.weight[:, :, 0].to(z.dtype), b)


class AdaLNResBlock(nn.Module):
    """Dilated freq-conv stack with adaLN sigma-conditioning: per layer
    ``gelu(norm(x) * (1 + affine(emb)))`` (the fused kernel), a conv with
    dilation 2^k, a ``gate(emb)`` output scale and residuals over sqrt(2);
    an optional projection-attention sub-block before the stack."""

    def __init__(self, dim_in: int, dim_out: int, emb_dim: int, num_dils: int = 6,
                 kernel=(5, 3), use_norm: bool = True, proj_place: str = "before",
                 attention: Optional[dict] = None, fdim: int = 0,
                 gelu: str = "erf"):
        super().__init__()
        N = dim_out if proj_place == "before" else dim_in
        self.use_norm = use_norm
        self.gelu = gelu
        self.num_dils = num_dils
        if dim_in != N:
            self.proj_in = Conv2dFT(dim_in, N)
        if attention is not None:
            a = attention
            if a.get("context_parallel", False):
                raise NotImplementedError(
                    "attention_dict.context_parallel is not ported yet")
            if use_norm:
                self.norm2 = NormGain(N)
            self.affine2 = Linear(emb_dim, N)
            self.gate2 = Linear(emb_dim, N, gate=True)
            self.attn_block = TimeAttention(
                N, fdim, num_heads=a.get("num_heads", 8),
                bias_qkv=a.get("bias_qkv", False),
                use_rel_pos=a.get("use_rel_pos", False),
                rel_pos_num_buckets=a.get("rel_pos_num_buckets", 32),
                rel_pos_max_distance=a.get("rel_pos_max_distance", 64))
        self.H = nn.ModuleList([Conv2dFT(N, N, kernel, dilation=(2 ** i, 1))
                                for i in range(num_dils)])
        if use_norm:
            self.norm = nn.ModuleList([NormGain(N) for _ in range(num_dils)])
        self.affine = nn.ModuleList([Linear(emb_dim, N) for _ in range(num_dils)])
        self.gate = nn.ModuleList([Linear(emb_dim, N, gate=True)
                                   for _ in range(num_dils)])
        if proj_place == "after" and N != dim_out:
            self.proj_out = Conv2dFT(N, dim_out)
        if dim_in != dim_out:
            self.res_conv = Conv2dFT(dim_in, dim_out)

    def _prologue(self, h: torch.Tensor, gain: torch.Tensor,
                  aff: torch.Tensor) -> torch.Tensor:
        """gelu(norm(h) * (1 + aff)) through the fused kernel."""
        C = h.shape[-1]
        g = min(8, C)
        h = h.contiguous()
        std = fused_adaln.group_std(h, g)
        return fused_adaln.norm_adaln_gelu(h, std, gain, aff.float(), 1e-7, g,
                                           gelu=self.gelu)

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = self.proj_in(x) if hasattr(self, "proj_in") else x
        if hasattr(self, "attn_block"):
            i_h = h
            gamma = self.affine2(emb)
            scale = self.gate2(emb)
            if self.use_norm:
                h = _norm_adaln_scale(h, self.norm2(), gamma)
            else:
                h = h * (gamma[:, None, None, :] + 1.0)
            h = self.attn_block(h) * scale[:, None, None, :]
            h = (h + i_h) / SQRT2
        for i in range(self.num_dils):
            h0 = h
            gamma = self.affine[i](emb)
            scale = self.gate[i](emb)
            if self.use_norm:
                g = self._prologue(h, self.norm[i](), gamma)
            else:
                g = fused_adaln.gelu_plain(h * (gamma[:, None, None, :] + 1.0),
                                           self.gelu)
            h = self.H[i](g)
            h = (h0 + h * scale[:, None, None, :]) / SQRT2
        if hasattr(self, "proj_out"):
            h = self.proj_out(h)
        res = self.res_conv(x) if hasattr(self, "res_conv") else x
        return (h + res) / SQRT2


# --------------------------------------------------------------------------
# FIR polyphase 2x time resampling, reflect padding; the upsampler keeps the
# reference's per-phase DC gain of 0.5 (trained decoders compensate for it).

_FIR_KERNELS = {
    "linear": [1 / 8, 3 / 8, 3 / 8, 1 / 8],
    "cubic": [-0.01171875, -0.03515625, 0.11328125, 0.43359375,
              0.43359375, 0.11328125, -0.03515625, -0.01171875],
    "lanczos3": [0.003689131001010537, 0.015056144446134567, -0.03399861603975296,
                 -0.066637322306633, 0.13550527393817902, 0.44638532400131226,
                 0.44638532400131226, 0.13550527393817902, -0.066637322306633,
                 -0.03399861603975296, 0.015056144446134567, 0.003689131001010537],
}


def _reflect(i: int, n: int) -> int:
    """Source index of position i of a reflect-padded axis of length n."""
    i = -i if i < 0 else i
    return 2 * (n - 1) - i if i >= n else i


def _resample_matrix_np(T: int, up: bool, kernel: str) -> np.ndarray:
    """[T_out, T_in] matrix of the reflect-padded 2x FIR resampler: down is
    y[t] = sum_k taps[k] xp[2t + k] (xp padded by k/2 - 1); up is the
    stride-2 transposed conv, y[n] = sum_k taps[k'] xp[(n + k) / 2] over the
    k with n + k even, k' = K-1-k (xp padded by (k/2) // 2)."""
    taps = _FIR_KERNELS[kernel]
    K = len(taps)
    pad = K // 2 - 1
    if not up:
        M = np.zeros((T // 2, T))
        for t in range(T // 2):
            for k in range(K):
                M[t, _reflect(2 * t + k - pad, T)] += taps[k]
        return M
    p = (pad + 1) // 2
    M = np.zeros((2 * T, T))
    for n in range(2 * T):
        for k in range(K):
            if (n + k) % 2 == 0:
                M[n, _reflect((n + k) // 2 - p, T)] += taps[K - 1 - k]
    return M


_RESAMPLE_CACHE: dict = {}


def resample_time(x: torch.Tensor, up: bool, kernel: str = "cubic") -> torch.Tensor:
    """2x FIR up/down-sampling along T of [B, F, T, C], as one matrix
    product over T with the resampler's banded [T_out, T] matrix (reflect
    padding folded in; the taps and their edge sums are exact in bf16)."""
    B, F_, T, C = x.shape
    key = (T, up, kernel, x.dtype, x.device)
    M = _RESAMPLE_CACHE.get(key)
    if M is None:
        M = torch.from_numpy(_resample_matrix_np(T, up, kernel)).to(x.device, x.dtype)
        _RESAMPLE_CACHE[key] = M
    y = torch.matmul(M, x.reshape(B * F_, T, C))
    return y.reshape(B, F_, y.shape[1], C)


# --------------------------------------------------------------------------


class UnetCQT(nn.Module):
    """The octave U-Net denoiser: forward(audio [B, T], cnoise [B, 1]) ->
    audio [B, T] (f32). The CQT is a fixed member, not a parameter."""

    def __init__(self, cqt: CQT, Ns: Sequence[int], num_dils: Sequence[int],
                 attention_layers: Sequence[int], attention: dict,
                 emb_dim: int = 256, use_norm: bool = True,
                 num_bottleneck_layers: int = 1, gelu: str = "erf",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cqt = cqt
        self.dtype = dtype
        O = cqt.num_octs
        bins = cqt.bins_per_oct
        self.bins = bins
        Ns = list(Ns)
        blk = dict(emb_dim=emb_dim, use_norm=use_norm, gelu=gelu)

        def attn(flag):
            return dict(attention) if flag else None

        self.embedding = RFFEmbedding(emb_dim)
        self.downs = nn.ModuleList()
        for i in range(O):
            d_init = Ns[i] if i == 0 else Ns[i - 1]
            self.downs.append(nn.ModuleList([
                AdaLNResBlock(2, d_init, num_dils=1, kernel=(1, 1), **blk),
                Conv2dFT(2, Ns[i], (5, 3)),
                AdaLNResBlock(d_init, Ns[i], num_dils=num_dils[i],
                              attention=attn(attention_layers[i]),
                              fdim=(i + 1) * bins, **blk)]))
        self.middle = nn.ModuleList()
        for _ in range(num_bottleneck_layers):
            self.middle.append(nn.ModuleList([
                AdaLNResBlock(Ns[-1], 2, num_dils=1, kernel=(1, 1),
                              proj_place="after", **blk),
                AdaLNResBlock(Ns[-1], Ns[-1], num_dils=num_dils[-1],
                              attention=attn(attention_layers[-1]),
                              fdim=O * bins, **blk)]))
        self.ups = nn.ModuleList()
        for i in range(O):
            oi = O - 1 - i
            d_out = Ns[oi - 1] if oi > 0 else Ns[0]
            self.ups.append(nn.ModuleList([
                AdaLNResBlock(d_out, 2, num_dils=1, kernel=(1, 1),
                              proj_place="after", **blk),
                AdaLNResBlock(2 * Ns[oi], d_out, num_dils=num_dils[oi],
                              attention=attn(attention_layers[oi]),
                              fdim=(oi + 1) * bins, **blk)]))

    def init_weights(self, seed: int = 0, gate_scale: float = GATE_SCALE) -> "UnetCQT":
        """Seeded random init with the reference's scheme (kaiming-uniform x
        sqrt(1/3), zero biases, unit norm gains, N(0,1) rel-pos tables,
        16 N(0,1) RFF frequencies). ``gate_scale`` sets the gate layers' scale
        (1e-7 as the reference; a trained net's gates are O(1))."""
        gen = torch.Generator().manual_seed(seed)
        for m in self.modules():
            if hasattr(m, "reset"):
                m.reset(gen, gate_scale)
        return self

    def store_weights_in_compute_dtype(self) -> "UnetCQT":
        """Store the conv, linear and qk weights in the compute dtype: every
        use casts them to it, so this saves the casts and changes no result."""
        for m in self.modules():
            if isinstance(m, (Conv2dFT, Linear, _QK)):
                m.to(self.dtype)
        return self

    def forward(self, audio: torch.Tensor, cnoise: torch.Tensor) -> torch.Tensor:
        O, bins, dt = self.cqt.num_octs, self.bins, self.dtype
        emb = self.embedding(cnoise, dt)
        X_list = self.cqt.fwd(audio[:, None, :])

        def to_real(c):  # complex [B, 1, bins, M] -> [B, bins, M, 2]
            return torch.view_as_real(c[:, 0]).to(dt)

        hs = []
        X = pyr = None
        for i, (init, pyr_conv, res) in enumerate(self.downs):
            C = to_real(X_list[O - 1 - i])
            C2 = init(C, emb)
            if i == 0:
                X, pyr = C2, C
            else:
                pyr = torch.cat([C, pyr], dim=1)
                X = torch.cat([C2, X], dim=1)
            X = res(X, emb)
            hs.append(X)
            if i < O - 1:
                # one resample for the main path and the raw-CQT pyramid
                nC = X.shape[-1]
                both = resample_time(torch.cat([X, pyr], dim=-1), up=False)
                X, pyr = both[..., :nC], both[..., nC:]
            X = (X + pyr_conv(pyr)) / SQRT2

        Xout = None
        for out_blk, res in self.middle:
            X = res(X, emb)
            Xout = out_blk(X, emb)

        X_out_list = [None] * O
        for i, (out_blk, res) in enumerate(self.ups):
            X = torch.cat([X, hs.pop()], dim=-1)
            X = res(X, emb)
            Xout = (Xout + out_blk(X, emb)) / SQRT2
            out_rows, Xout = Xout[:, :bins], Xout[:, bins:]
            X = X[:, bins:]
            X_out_list[i] = torch.view_as_complex(
                out_rows.float().contiguous())[:, None]          # [B, 1, bins, M]
            if i < O - 1:
                nC = X.shape[-1]
                both = resample_time(torch.cat([X, Xout], dim=-1), up=True)
                X, Xout = both[..., :nC], both[..., nC:]

        pred = self.cqt.bwd(X_out_list)[:, 0]
        return pred[:, : audio.shape[-1]].float()


# --------------------------------------------------------------------------

# Network keys that only select a TPU layout rewrite of the same math; the
# port has one (plain) formulation, so they are read and ignored.
_TPU_LAYOUT_KEYS = ("conv_foldf", "conv_pack_stack", "conv_chain_regroup",
                    "chain_stride", "use_pallas_fused")


def build_unet(args, device=None) -> UnetCQT:
    """Factory from the config tree (``network.callable``); returns the
    module on the CPU in f32 storage; ``setup.setup_network`` places it."""
    net = args.network
    for key in _TPU_LAYOUT_KEYS:
        net.get(key)  # TPU layout rewrites of the same math: ignored
    unported = {"quant": net.get("quant", "none") != "none",
                "context_parallel": bool(net.get("context_parallel", False)),
                "remat": bool(net.get("remat", False)),
                "use_fencoding": bool(net.get("use_fencoding", False))}
    for key, on in unported.items():
        if on:
            raise NotImplementedError(
                f"network.{key}={net.get(key)!r} is not ported to aid_tpu_torch yet")
    win = (("kaiser", net.cqt.beta) if net.cqt.window == "kaiser" else net.cqt.window)
    dtype = (torch.bfloat16 if str(net.get("compute_dtype", "float32")) == "bfloat16"
             else torch.float32)
    cqt = get_cqt(net.cqt.num_octs, net.cqt.bins_per_oct, args.exp.sample_rate,
                  args.exp.audio_len, window=win)
    attention = dict(net.attention_dict) if "attention_dict" in net else {}
    return UnetCQT(
        cqt=cqt, Ns=tuple(net.Ns), num_dils=tuple(net.num_dils),
        attention_layers=tuple(net.attention_layers), attention=attention,
        emb_dim=net.emb_dim, use_norm=net.use_norm,
        num_bottleneck_layers=int(net.get("num_bottleneck_layers", 1)),
        gelu=str(net.get("gelu", "erf")), dtype=dtype)
