"""Plain float32 DiffWave, unconditional, for the port's tests: the layer
equations of lmnt's public implementation (github.com/lmnt-com/diffwave,
``src/diffwave/model.py``) written once more with ``torch.nn`` layers, and
nothing else: no kernel, cache, batching, folding or dtype switch. Imports
nothing of ``aid_tpu_torch`` or JAX.

Departures from the paper (Kong et al., arXiv:2009.09761), each as the port
makes it:
  * the step embedding is evaluated at EDM's continuous t = c_noise
    (log(sigma) / 4), not looked up at an integer DDPM step;
  * no spectrogram conditioner (the unconditional model);
  * the weights are whatever the caller loads (no init here).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


class DiffusionEmbedding(nn.Module):
    def __init__(self, emb_dim: int, hidden: int):
        super().__init__()
        self.emb_dim = emb_dim
        self.projection1 = nn.Linear(emb_dim, hidden)
        self.projection2 = nn.Linear(hidden, hidden)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        h = self.emb_dim // 2
        dims = torch.arange(h, dtype=torch.float32, device=t.device)
        table = t.reshape(-1, 1) * 10.0 ** (dims * 4.0 / (h - 1))
        x = torch.cat([torch.sin(table), torch.cos(table)], dim=1)
        return F.silu(self.projection2(F.silu(self.projection1(x))))


class ResidualBlock(nn.Module):
    def __init__(self, channels: int, dilation: int, hidden: int):
        super().__init__()
        self.dilated_conv = nn.Conv1d(channels, 2 * channels, 3, padding=dilation,
                                      dilation=dilation)
        self.diffusion_projection = nn.Linear(hidden, channels)
        self.output_projection = nn.Conv1d(channels, 2 * channels, 1)

    def forward(self, x, e):
        y = self.dilated_conv(x + self.diffusion_projection(e)[:, :, None])
        gate, filt = torch.chunk(y, 2, dim=1)
        y = self.output_projection(torch.sigmoid(gate) * torch.tanh(filt))
        residual, skip = torch.chunk(y, 2, dim=1)
        return (x + residual) / math.sqrt(2.0), skip


class DiffWave(nn.Module):
    """forward(audio [B, L], t [B, 1]) -> [B, L]."""

    def __init__(self, residual_channels: int = 256, residual_layers: int = 36,
                 dilation_cycle_length: int = 12, emb_dim: int = 128, emb_hidden: int = 512):
        super().__init__()
        C = residual_channels
        self.input_projection = nn.Conv1d(1, C, 1)
        self.diffusion_embedding = DiffusionEmbedding(emb_dim, emb_hidden)
        self.residual_layers = nn.ModuleList([
            ResidualBlock(C, 2 ** (i % dilation_cycle_length), emb_hidden)
            for i in range(residual_layers)])
        self.skip_projection = nn.Conv1d(C, C, 1)
        self.output_projection = nn.Conv1d(C, 1, 1)

    def forward(self, audio: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.input_projection(audio[:, None]))
        e = self.diffusion_embedding(t)
        skip = None
        for layer in self.residual_layers:
            x, s = layer(x, e)
            skip = s if skip is None else skip + s
        x = skip / math.sqrt(len(self.residual_layers))
        return self.output_projection(F.relu(self.skip_projection(x)))[:, 0]
