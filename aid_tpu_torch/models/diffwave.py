"""DiffWave, unconditional, as a waveform denoiser under EDM.

Kong, Ping, Huang, Zhao and Catanzaro, "DiffWave: A Versatile Diffusion Model
for Audio Synthesis", ICLR 2021 (arXiv:2009.09761), in the form of the public
implementation (github.com/lmnt-com/diffwave, ``src/diffwave/model.py``),
without the spectrogram conditioner. Channels first, [B, C, L]:

    x = relu(input_projection(audio[:, None]))                  Conv1d(1, C, 1)
    e = silu(projection2(silu(projection1(emb(t)))))             128 -> 512 -> 512
    each residual layer i (dilation d = 2^(i mod cycle)):
        y = x + diffusion_projection(e)[:, :, None]              Linear(512, C)
        z = dilated_conv(y)                                      Conv1d(C, 2C, 3, d)
        g = sigmoid(z[:, :C]) tanh(z[:, C:])                     ops.gated_tanh
        residual, skip = output_projection(g).chunk(2, dim=1)    Conv1d(C, 2C, 1)
        x = (x + residual) / sqrt(2)
    out = output_projection(relu(skip_projection(sum(skip) / sqrt(layers))))

with emb(t) = [sin(t 10^(4i/63)), cos(t 10^(4i/63))], i = 0..63, computed
from t (no table). Departure from the published net: t is EDM's continuous
c_noise = log(sigma) / 4 that ``diffusion.edm.denoiser`` passes, where the
paper looks up integer DDPM steps. The parameter names are lmnt's state-dict
keys, so a released unconditional checkpoint loads as it is.

``forward(audio [B, L], cnoise [B, 1]) -> [B, L]`` (f32), in ``dtype``
(weights stored in it for serving, ``store_weights_in_compute_dtype``).
``remat`` rematerialises every residual layer in the backward while
gradients are recorded. ``quant="int8"`` runs every conv through
``ops.qconv`` (serving only); ``quant="fp8"`` rounds every conv's input
and weight to float8 e4m3, a lower-precision control for accuracy checks
that saves neither time nor memory. The residual stack of each forward is the
phase mark ``dw.stack`` inside a captured graph.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from aid_tpu_torch.ops import gated_tanh as gt
from aid_tpu_torch.ops import qconv
from aid_tpu_torch.utils import trace

QUANT_MODES = ("none", "int8", "fp8")
FP8_MAX = 448.0         # the largest float8 e4m3 number
CONV_FORMS = ("dilated", "folded")
# The dilated conv's form by the dtype it runs in and its dilation: folded
# into the batch from FOLD_FROM[dtype], cuDNN's dilated conv1d below it and
# in a dtype not listed. On an H100 at [2, 256, 131072] bf16 (serving) the
# forward and the input gradient took 1.75 ms dilated against 2.8-3.4 ms
# folded at d = 2..8, and 8.9-9.2 ms dilated against 4.4-7.5 ms folded at
# d = 16..2048; in f32 (training, TF32 convs) the conv with both gradients
# is faster dilated at every d, and a captured step at batch 4 took 919-926 ms
# with every conv dilated against 1206-1207 ms folded from 16 (PERF.md, PR 18).
FOLD_FROM = {torch.bfloat16: 16}


def sinusoid(t: torch.Tensor, dim: int) -> torch.Tensor:
    """[sin(t 10^(4i/(h-1))), cos(...)], i < h = dim / 2, of t [B, 1] -> [B, dim] f32."""
    h = dim // 2
    freqs = 10.0 ** (torch.arange(h, dtype=torch.float32, device=t.device) * (4.0 / (h - 1)))
    a = t.float().reshape(-1, 1) * freqs
    return torch.cat([torch.sin(a), torch.cos(a)], dim=1)


def dilated_conv1d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], d: int,
                   form: str) -> torch.Tensor:
    """Conv1d(k=3, dilation d, padding d) of x [B, C, L]. ``folded``: phase
    r of t = q d + r is row q of batch entry (b, r), so the conv runs
    undilated on B d rows of L / d samples (exact: the taps t -/+ d are
    the same phase's q -/+ 1, the padding its ends). A length that d does
    not divide is zero-padded up to one it does, and the output cut back:
    the padding is the zeros the conv's own right padding reads."""
    if form == "dilated" or d == 1:
        return F.conv1d(x, w, b, padding=d, dilation=d)
    B, C, L = x.shape
    q = -(-L // d)
    if q * d != L:
        x = F.pad(x, (0, q * d - L))
    xf = x.reshape(B, C, q, d).permute(0, 3, 1, 2).reshape(B * d, C, q)
    y = F.conv1d(xf, w, b, padding=1)
    y = y.reshape(B, d, -1, q).permute(0, 2, 3, 1).reshape(B, -1, q * d)
    return y if q * d == L else y[:, :, :L].contiguous()


def _qconv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, d: int) -> torch.Tensor:
    """The int8 conv of ``ops.qconv`` on [B, C, L]: time as its dilated
    (frequency) axis of a channels-last [B, L, 1, C] view."""
    if w.shape[2] == 1:
        y = qconv.qdot(x.transpose(1, 2), w[:, :, 0]).transpose(1, 2)
    else:
        y = qconv.qconv(x.transpose(1, 2)[:, :, None, :], w[:, :, :, None], dilation=d)
        y = y[:, :, 0, :].transpose(1, 2)
    return (y + b[:, None]).contiguous()


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 at a scale of its own per leading index (its
    largest magnitude to 448), back in t's dtype; the gradient passes
    through unchanged."""
    s = t.detach().float().abs().amax(dim=tuple(range(1, t.dim())), keepdim=True)
    s = torch.clamp_min(s / FP8_MAX, 1e-12)
    q = ((t.detach().float() / s).to(torch.float8_e4m3fn).float() * s).to(t.dtype)
    return t + (q - t).detach()


class Conv1d(nn.Conv1d):
    """nn.Conv1d applied in x's dtype: k=1, or k=3 at ``dilation`` d
    (padding d) in the form ``FOLD_FROM`` gives; ``quant="int8"`` through
    ``ops.qconv``;
    ``quant="fp8"`` with x (per batch row) and the weight (per output
    channel) rounded to float8 e4m3 first, the products summed in x's
    dtype."""

    def __init__(self, cin: int, cout: int, kernel: int = 1, dilation: int = 1,
                 quant: str = "none"):
        super().__init__(cin, cout, kernel, padding=dilation if kernel > 1 else 0,
                         dilation=dilation)
        self.quant = quant

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b, d = self.weight.to(x.dtype), self.bias.to(x.dtype), self.dilation[0]
        if self.quant == "int8":
            return _qconv1d(x, w, b, d)
        if self.quant == "fp8":
            x, w = _fp8(x), _fp8(w)
        if self.kernel_size[0] == 1:
            return F.conv1d(x, w, b)
        form = "folded" if d >= FOLD_FROM.get(x.dtype, math.inf) else "dilated"
        return dilated_conv1d(x, w, b, d, form)


class Linear(nn.Linear):
    """nn.Linear applied in x's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class DiffusionEmbedding(nn.Module):
    def __init__(self, emb_dim: int, hidden: int):
        super().__init__()
        self.emb_dim = emb_dim
        self.projection1 = Linear(emb_dim, hidden)
        self.projection2 = Linear(hidden, hidden)

    def forward(self, t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        e = F.silu(self.projection1(sinusoid(t, self.emb_dim).to(dtype)))
        return F.silu(self.projection2(e))


class ResidualBlock(nn.Module):
    def __init__(self, channels: int, dilation: int, hidden: int, quant: str):
        super().__init__()
        self.dilated_conv = Conv1d(channels, 2 * channels, 3, dilation, quant)
        self.diffusion_projection = Linear(hidden, channels)
        self.output_projection = Conv1d(channels, 2 * channels, 1, quant=quant)

    def forward(self, x: torch.Tensor, e: torch.Tensor):
        y = x + self.diffusion_projection(e)[:, :, None]
        y = self.output_projection(gt.gated_tanh(self.dilated_conv(y)))
        residual, skip = y.chunk(2, dim=1)
        return (x + residual) / math.sqrt(2.0), skip


class DiffWave(nn.Module):
    """The unconditional DiffWave denoiser (module docstring): forward(audio
    [B, L], cnoise [B, 1]) -> [B, L] f32. Each dilated conv takes its form
    from its dilation and the compute dtype (``FOLD_FROM``)."""

    def __init__(self, residual_channels: int = 256, residual_layers: int = 36,
                 dilation_cycle_length: int = 12, emb_dim: int = 128, emb_hidden: int = 512,
                 dtype: torch.dtype = torch.float32, remat: bool = False, quant: str = "none"):
        super().__init__()
        if quant not in QUANT_MODES:
            raise ValueError(f"network.quant={quant!r}: expected one of {QUANT_MODES}")
        C = residual_channels
        self.dtype, self.remat, self.quant = dtype, remat, quant
        self.input_projection = Conv1d(1, C, 1, quant=quant)
        self.diffusion_embedding = DiffusionEmbedding(emb_dim, emb_hidden)
        dils = [2 ** (i % dilation_cycle_length) for i in range(residual_layers)]
        self.residual_layers = nn.ModuleList([
            ResidualBlock(C, d, emb_hidden, quant) for d in dils])
        self.skip_projection = Conv1d(C, C, 1, quant=quant)
        self.output_projection = Conv1d(C, 1, 1, quant=quant)

    @property
    def context_parallel(self) -> bool:
        return False

    @context_parallel.setter
    def context_parallel(self, on: bool) -> None:
        if on:
            raise ValueError("DiffWave does not split its time axis over ranks "
                             "(network.context_parallel must be False)")

    def init_weights(self, seed: int = 0) -> "DiffWave":
        """Seeded random init with lmnt's scheme: every conv's weight
        kaiming-normal (std sqrt(2 / fan in)), the final output projection's
        zero, the rest as PyTorch's defaults (uniform in +-1/sqrt(fan in))."""
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for m in self.modules():
                if not isinstance(m, (nn.Conv1d, nn.Linear)):
                    continue
                fan_in = m.weight[0].numel()
                bound = 1.0 / math.sqrt(fan_in)
                if isinstance(m, nn.Conv1d):
                    m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                                   * math.sqrt(2.0 / fan_in))
                else:
                    m.weight.copy_((torch.rand(m.weight.shape, generator=gen) * 2 - 1) * bound)
                m.bias.copy_((torch.rand(m.bias.shape, generator=gen) * 2 - 1) * bound)
            self.output_projection.weight.zero_()
        return self

    def store_weights_in_compute_dtype(self) -> "DiffWave":
        """Store every weight in the compute dtype: each use casts to it, so
        this saves the casts and changes no result."""
        return self.to(self.dtype)

    def _layer(self, layer: ResidualBlock, x: torch.Tensor, e: torch.Tensor):
        if not (self.remat and torch.is_grad_enabled()):
            return layer(x, e)
        # a layer draws no random numbers, so the recomputation needs no saved
        # RNG state (reading it is not allowed inside a CUDA graph capture)
        return checkpoint(layer, x, e, use_reentrant=False, preserve_rng_state=False)

    def forward(self, audio: torch.Tensor, cnoise: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = F.relu(self.input_projection(audio[:, None].to(dt)))
        e = self.diffusion_embedding(cnoise, dt)
        skip = None
        with trace.mark("dw.stack"):
            for layer in self.residual_layers:
                x, s = self._layer(layer, x, e)
                skip = s if skip is None else skip + s
        x = F.relu(self.skip_projection(skip / math.sqrt(len(self.residual_layers))))
        return self.output_projection(x)[:, 0].float()


def _options(net) -> Dict:
    if bool(net.get("context_parallel", False)):
        raise ValueError("DiffWave does not split its time axis over ranks "
                         "(network.context_parallel must be False)")
    policy = str(net.get("remat_policy", "block"))
    if policy != "block":
        raise ValueError(f"network.remat_policy={policy!r}: DiffWave rematerialises whole "
                         "residual layers ('block')")
    return dict(residual_channels=int(net.residual_channels),
                residual_layers=int(net.residual_layers),
                dilation_cycle_length=int(net.dilation_cycle_length),
                emb_dim=int(net.emb_dim), emb_hidden=int(net.emb_hidden),
                dtype=(torch.bfloat16 if str(net.get("compute_dtype", "float32")) == "bfloat16"
                       else torch.float32),
                remat=bool(net.get("remat", False)), quant=str(net.get("quant", "none")))


def build_diffwave(args, device=None) -> DiffWave:
    """Factory from the config tree (``network.callable``); returns the
    module on the CPU in f32 storage; ``setup.setup_network`` places it."""
    return DiffWave(**_options(args.network))
