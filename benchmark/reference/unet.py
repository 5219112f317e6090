"""Plain reference of the CQTDiff+ octave U-Net denoiser, in float32.

A frozen copy of the mathematics of ``aid_tpu_torch/models/unet_cqt.py``
(the port's ``UnetCQT`` in its plain formulation) for the options the
benchmark's configurations use: octave CQT in and out, adaLN residual
blocks of frequency-dilated (5, 3) convs with the group-norm x adaLN x GELU
prologue written out in plain torch, projection attention along time
without a relative-position bias, the FIR 2x time resamplers, and the
random-Fourier noise embedding. No kernel, no remat, no parallelism, no
int8. Parameter names are the port's state-dict names, so one dictionary of
weights loads into both. Imports nothing of the port.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

SQRT2 = math.sqrt(2.0)
GROUPS = 8
EPS = 1e-7


def gelu(v: torch.Tensor, variant: str) -> torch.Tensor:
    if variant == "tanh":
        return F.gelu(v, approximate="tanh")
    if variant == "sigmoid":
        return v * torch.sigmoid(1.702 * v)
    return F.gelu(v)


def group_std(x: torch.Tensor, groups: int) -> torch.Tensor:
    """Bessel-corrected std over (F, T, C/G) of [B, F, T, C] by one-pass
    moments, as the port computes it -> [B, G]."""
    B, F_, T, C = x.shape
    xf = x.float().reshape(B, F_ * T, groups, C // groups)
    n = F_ * T * (C // groups)
    m1 = xf.mean(dim=(1, 3))
    m2 = xf.square().mean(dim=(1, 3))
    return (torch.clamp_min(m2 - m1 * m1, 0.0) * (n / (n - 1.0))).sqrt()


def norm_scale(x: torch.Tensor, gamma: torch.Tensor, aff: torch.Tensor) -> torch.Tensor:
    """x * gamma / (group std + eps) * (1 + aff), per (batch, channel)."""
    B, _, _, C = x.shape
    g = min(GROUPS, C)
    inv = gamma.reshape(1, g, C // g) / (group_std(x, g)[:, :, None] + EPS)
    return x * (inv.reshape(B, 1, 1, C) * (1.0 + aff).reshape(B, 1, 1, C))


class Conv(nn.Module):
    """Bias-free conv over (F, T) of channels-last [B, F, T, C], SAME
    padding, frequency dilation; ``weight`` OIHW."""

    def __init__(self, cin: int, cout: int, kernel=(1, 1), dil: int = 1):
        super().__init__()
        self.kernel, self.dil = tuple(kernel), dil
        self.weight = nn.Parameter(torch.empty(cout, cin, *self.kernel))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        if self.kernel == (1, 1):
            return torch.matmul(x, w[:, :, 0, 0].t())
        kh, kw = self.kernel
        d = self.dil
        B, F_, T, C = x.shape
        q = -(-F_ // d)
        x = F.pad(x, (0, 0, 0, 0, 0, q * d - F_))
        # row f = q' d + r of a dilated conv is row q' of phase r, undilated
        x = x.reshape(B, q, d, T, C).transpose(1, 2).reshape(B * d, q, T, C)
        y = F.conv2d(x.permute(0, 3, 1, 2), w, padding=(kh // 2, kw // 2)).permute(0, 2, 3, 1)
        y = y.reshape(B, d, q, T, -1).transpose(1, 2).reshape(B, q * d, T, -1)
        return y[:, :F_]


class Attention(nn.Module):
    """Projection attention along time: channels to heads by a 1x1 conv,
    frequency folded into each head's features, V the projection itself."""

    def __init__(self, channels: int, fdim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.proj_in = Conv(channels, heads)
        self.proj_out = Conv(heads, channels)
        self.qk = nn.Module()
        self.qk.weight = nn.Parameter(torch.empty(2 * heads * fdim, heads * fdim, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, F_, T, C = x.shape
        H = self.heads
        h = self.proj_in(x)
        z = h.permute(0, 2, 3, 1).reshape(B, T, H * F_)
        v = z.reshape(B, T, H, F_).permute(0, 2, 1, 3)
        qk = F.linear(z, self.qk.weight[:, :, 0]).reshape(B, T, H, 2 * F_).permute(0, 2, 1, 3)
        q, k = qk.split(F_, dim=-1)
        attn = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * float(F_) ** -0.5, dim=-1)
        return self.proj_out(torch.matmul(attn, v).permute(0, 3, 2, 1))


class Gain(nn.Module):
    def __init__(self, n: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.empty(1, n, 1, 1))


class Block(nn.Module):
    """adaLN residual block: optional attention sub-block, then per layer
    h = (h + conv(gelu(norm(h) (1 + affine(emb)))) gate(emb)) / sqrt 2."""

    def __init__(self, din: int, dout: int, emb: int, dils: int, kernel=(5, 3),
                 proj_after: bool = False, attention: Optional[dict] = None, fdim: int = 0,
                 gelu_variant: str = "tanh"):
        super().__init__()
        N = din if proj_after else dout
        self.dils, self.gelu = dils, gelu_variant
        if din != N:
            self.proj_in = Conv(din, N)
        if attention is not None:
            self.norm2 = Gain(N)
            self.affine2 = nn.Linear(emb, N)
            self.gate2 = nn.Linear(emb, N)
            self.attn_block = Attention(N, fdim, int(attention.get("num_heads", 8)))
        self.H = nn.ModuleList([Conv(N, N, kernel, 2 ** i) for i in range(dils)])
        self.norm = nn.ModuleList([Gain(N) for _ in range(dils)])
        self.affine = nn.ModuleList([nn.Linear(emb, N) for _ in range(dils)])
        self.gate = nn.ModuleList([nn.Linear(emb, N) for _ in range(dils)])
        if proj_after and N != dout:
            self.proj_out = Conv(N, dout)
        if din != dout:
            self.res_conv = Conv(din, dout)

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = self.proj_in(x) if hasattr(self, "proj_in") else x
        if hasattr(self, "attn_block"):
            a = norm_scale(h, self.norm2.gamma.reshape(-1), self.affine2(emb))
            h = (self.attn_block(a) * self.gate2(emb)[:, None, None, :] + h) / SQRT2
        for i in range(self.dils):
            g = gelu(norm_scale(h, self.norm[i].gamma.reshape(-1), self.affine[i](emb)), self.gelu)
            h = (h + self.H[i](g) * self.gate[i](emb)[:, None, None, :]) / SQRT2
        if hasattr(self, "proj_out"):
            h = self.proj_out(h)
        return (h + (self.res_conv(x) if hasattr(self, "res_conv") else x)) / SQRT2


FIR_CUBIC = [-0.01171875, -0.03515625, 0.11328125, 0.43359375,
             0.43359375, 0.11328125, -0.03515625, -0.01171875]


def _reflect(i: int, n: int) -> int:
    i = -i if i < 0 else i
    return 2 * (n - 1) - i if i >= n else i


def resample_matrix(T: int, up: bool) -> np.ndarray:
    """[T_out, T] matrix of the reflect-padded cubic 2x FIR resampler (the
    upsampler a stride-2 transposed conv with per-phase DC gain 0.5)."""
    taps, K = FIR_CUBIC, len(FIR_CUBIC)
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


class UNet(nn.Module):
    """forward(audio [B, L], cnoise [B, 1]) -> [B, L] float32. ``cqt`` may be
    None to enumerate parameters only (``param_shapes``)."""

    def __init__(self, net: dict, cqt=None):
        super().__init__()
        unsupported = {k: net.get(k) for k in ("use_fencoding", "quant")
                       if net.get(k) not in (None, False, "none")}
        att = dict(net.get("attention_dict", {}))
        if att.get("use_rel_pos") or att.get("bias_qkv") or int(net.get("num_bottleneck_layers", 1)) != 1:
            unsupported["attention_dict/bottleneck"] = att
        if unsupported or not net.get("use_norm", True):
            raise ValueError(f"the reference does not implement {unsupported or 'use_norm False'}")
        self.cqt = cqt
        O, bins = int(net["cqt"]["num_octs"]), int(net["cqt"]["bins_per_oct"])
        self.O, self.bins = O, bins
        Ns, dils, attl = list(net["Ns"]), list(net["num_dils"]), list(net["attention_layers"])
        emb = int(net["emb_dim"])
        g = str(net.get("gelu", "erf"))

        def blk(din, dout, dn, **kw):
            return Block(din, dout, emb, dn, gelu_variant=g, **kw)

        def attn(flag):
            return att if flag else None

        self.embedding = nn.Module()
        self.embedding.RFF_freq = nn.Parameter(torch.empty(1, 32), requires_grad=False)
        self.embedding.MLP = nn.ModuleList([nn.Linear(64, 128), nn.Linear(128, 256),
                                            nn.Linear(256, emb)])
        self.downs = nn.ModuleList()
        for i in range(O):
            d0 = Ns[0] if i == 0 else Ns[i - 1]
            self.downs.append(nn.ModuleList([
                blk(2, d0, 1, kernel=(1, 1)), Conv(2, Ns[i], (5, 3)),
                blk(d0, Ns[i], dils[i], attention=attn(attl[i]), fdim=(i + 1) * bins)]))
        self.middle = nn.ModuleList([nn.ModuleList([
            blk(Ns[-1], 2, 1, kernel=(1, 1), proj_after=True),
            blk(Ns[-1], Ns[-1], dils[-1], attention=attn(attl[-1]), fdim=O * bins)])])
        self.ups = nn.ModuleList()
        for i in range(O):
            oi = O - 1 - i
            dout = Ns[oi - 1] if oi > 0 else Ns[0]
            self.ups.append(nn.ModuleList([
                blk(dout, 2, 1, kernel=(1, 1), proj_after=True),
                blk(2 * Ns[oi], dout, dils[oi], attention=attn(attl[oi]), fdim=(oi + 1) * bins)]))
        self._mats: Dict[Tuple, torch.Tensor] = {}

    def _resample(self, x: torch.Tensor, up: bool) -> torch.Tensor:
        B, F_, T, C = x.shape
        key = (T, up, x.device)
        if key not in self._mats:
            self._mats[key] = torch.from_numpy(resample_matrix(T, up)).float().to(x.device)
        y = torch.matmul(self._mats[key], x.reshape(B * F_, T, C))
        return y.reshape(B, F_, y.shape[1], C)

    def forward(self, audio: torch.Tensor, cnoise: torch.Tensor) -> torch.Tensor:
        O, bins = self.O, self.bins
        table = 2.0 * math.pi * cnoise.float() * self.embedding.RFF_freq
        emb = torch.cat([torch.sin(table), torch.cos(table)], dim=-1)
        for lin in self.embedding.MLP:
            emb = torch.relu(lin(emb))
        X_list = self.cqt.fwd(audio[:, None, :])
        hs: List[torch.Tensor] = []
        X = pyr = None
        for i, (init, pyr_conv, res) in enumerate(self.downs):
            C = torch.view_as_real(X_list[O - 1 - i][:, 0])
            C2 = init(C, emb)
            if i == 0:
                X, pyr = C2, C
            else:
                pyr = torch.cat([C, pyr], dim=1)
                X = torch.cat([C2, X], dim=1)
            X = res(X, emb)
            hs.append(X)
            if i < O - 1:
                nC = X.shape[-1]
                both = self._resample(torch.cat([X, pyr], dim=-1), False)
                X, pyr = both[..., :nC], both[..., nC:]
            X = (X + pyr_conv(pyr)) / SQRT2
        out_blk, res = self.middle[0]
        X = res(X, emb)
        Xout = out_blk(X, emb)
        outs = [None] * O
        for i, (out_blk, res) in enumerate(self.ups):
            X = res(torch.cat([X, hs.pop()], dim=-1), emb)
            Xout = (Xout + out_blk(X, emb)) / SQRT2
            rows, Xout = Xout[:, :bins], Xout[:, bins:]
            X = X[:, bins:]
            outs[i] = torch.view_as_complex(rows.float().contiguous())[:, None]
            if i < O - 1:
                nC = X.shape[-1]
                both = self._resample(torch.cat([X, Xout], dim=-1), True)
                X, Xout = both[..., :nC], both[..., nC:]
        return self.cqt.bwd(outs)[:, 0, :audio.shape[-1]].float()


def param_shapes(net: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every parameter, in name order."""
    with torch.device("meta"):
        m = UNet(net)
    return sorted((n, tuple(p.shape)) for n, p in m.named_parameters())
