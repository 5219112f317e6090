"""DiffWave, unconditional, as the harness finds an architecture by the name a
configuration file states (``"architecture": "diffwave"``): the parameters'
names and shapes, and the plain float32 net, which has no output filter.

The layer equations of the public implementation (github.com/lmnt-com/diffwave,
``src/diffwave/model.py``; Kong et al., arXiv:2009.09761) with ``torch.nn``
layers alone: the step's sinusoid [sin(t 10^(4i/63)), cos(...)] through two
swish layers, then each residual layer x + diffusion_projection(e), a
dilated k=3 conv C -> 2C (dilation 2^(i mod cycle)), sigmoid(gate) x
tanh(filter), a 1x1 conv C -> 2C split into residual and skip, and
(x + residual) / sqrt(2); the skips summed over sqrt(layers), a 1x1 conv,
relu, a 1x1 conv to one channel. The step t is EDM's continuous c_noise the
sampler passes, where the paper looks up integer steps. Imports nothing of
the port.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def _sizes(network: dict):
    return (int(network["residual_channels"]), int(network["residual_layers"]),
            int(network["dilation_cycle_length"]), int(network["emb_dim"]),
            int(network["emb_hidden"]))


def param_shapes(network: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every parameter, under lmnt's state-dict names."""
    C, n, _, E, H = _sizes(network)
    out = [("input_projection.weight", (C, 1, 1)), ("input_projection.bias", (C,)),
           ("diffusion_embedding.projection1.weight", (H, E)),
           ("diffusion_embedding.projection1.bias", (H,)),
           ("diffusion_embedding.projection2.weight", (H, H)),
           ("diffusion_embedding.projection2.bias", (H,)),
           ("skip_projection.weight", (C, C, 1)), ("skip_projection.bias", (C,)),
           ("output_projection.weight", (1, C, 1)), ("output_projection.bias", (1,))]
    for i in range(n):
        p = f"residual_layers.{i}."
        out += [(p + "dilated_conv.weight", (2 * C, C, 3)), (p + "dilated_conv.bias", (2 * C,)),
                (p + "diffusion_projection.weight", (C, H)), (p + "diffusion_projection.bias", (C,)),
                (p + "output_projection.weight", (2 * C, C, 1)),
                (p + "output_projection.bias", (2 * C,))]
    return sorted(out)


class _Embedding(nn.Module):
    def __init__(self, E: int, H: int):
        super().__init__()
        self.E = E
        self.projection1 = nn.Linear(E, H)
        self.projection2 = nn.Linear(H, H)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        h = self.E // 2
        dims = torch.arange(h, dtype=torch.float32, device=t.device)
        table = t.reshape(-1, 1) * 10.0 ** (dims * 4.0 / (h - 1))
        x = torch.cat([torch.sin(table), torch.cos(table)], dim=1)
        return F.silu(self.projection2(F.silu(self.projection1(x))))


class _Layer(nn.Module):
    def __init__(self, C: int, d: int, H: int):
        super().__init__()
        self.dilated_conv = nn.Conv1d(C, 2 * C, 3, padding=d, dilation=d)
        self.diffusion_projection = nn.Linear(H, C)
        self.output_projection = nn.Conv1d(C, 2 * C, 1)

    def forward(self, x, e):
        y = self.dilated_conv(x + self.diffusion_projection(e)[:, :, None])
        gate, filt = torch.chunk(y, 2, dim=1)
        residual, skip = torch.chunk(
            self.output_projection(torch.sigmoid(gate) * torch.tanh(filt)), 2, dim=1)
        return (x + residual) / math.sqrt(2.0), skip


class DiffWave(nn.Module):
    """forward(audio [B, L], t [B, 1]) -> [B, L]."""

    def __init__(self, network: dict):
        super().__init__()
        C, n, cycle, E, H = _sizes(network)
        self.input_projection = nn.Conv1d(1, C, 1)
        self.diffusion_embedding = _Embedding(E, H)
        self.residual_layers = nn.ModuleList([_Layer(C, 2 ** (i % cycle), H) for i in range(n)])
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


def build(cfg: dict, device) -> Tuple[torch.nn.Module, Optional[object]]:
    """(the net on ``device`` with uninitialised weights, no output filter)."""
    with torch.device(device):
        return DiffWave(cfg["network"]), None
