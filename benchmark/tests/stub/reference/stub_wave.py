"""Plain reference of the benchmark tests' stub architecture (``stub_wave``):
a dilated k=3 conv of the waveform to ``channels`` plus the noise level's
embedding, the gate tanh x sigmoid, a 1x1 conv back, in float32, with no
output filter. Imports nothing of the port."""
from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def param_shapes(network: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    C = int(network["channels"])
    return sorted([("emb.weight", (C, 1)), ("inp.weight", (C, 1, 3)), ("out.weight", (1, C, 1))])


class Net(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.emb = nn.Module()
        self.emb.weight = nn.Parameter(torch.empty(channels, 1))
        self.inp = nn.Module()
        self.inp.weight = nn.Parameter(torch.empty(channels, 1, 3))
        self.out = nn.Module()
        self.out.weight = nn.Parameter(torch.empty(1, channels, 1))

    def forward(self, audio: torch.Tensor, cnoise: torch.Tensor) -> torch.Tensor:
        h = F.conv1d(audio[:, None], self.inp.weight, padding=2, dilation=2) \
            + (cnoise @ self.emb.weight.T)[:, :, None]
        return F.conv1d(torch.tanh(h) * torch.sigmoid(h), self.out.weight)[:, 0]


def build(cfg: dict, device):
    with torch.device(device):
        return Net(int(cfg["network"]["channels"])), None
