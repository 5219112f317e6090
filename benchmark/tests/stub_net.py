"""The program's side of a stub architecture for the benchmark's tests: a
one-layer gated dilated-conv denoiser over the waveform, which the port's
sampler and inpainting service run through ``network.callable``
(``stub_net.build``) as they run the U-Net. Its plain reference and its
work are ``tests/stub/reference/stub_wave.py`` and
``tests/stub/work/stub_wave.py``."""
from __future__ import annotations

import math

import torch
from torch import nn


class StubNet(nn.Module):
    """forward(audio [B, L], cnoise [B, 1]) -> [B, L]: a dilated k=3 conv to
    ``channels`` plus the noise level's embedding, the gate tanh x sigmoid,
    a 1x1 conv back to one channel."""

    def __init__(self, channels: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.emb = nn.Linear(1, channels, bias=False)
        self.inp = nn.Conv1d(1, channels, 3, padding=2, dilation=2, bias=False)
        self.out = nn.Conv1d(channels, 1, 1, bias=False)

    def init_weights(self, seed: int = 0) -> "StubNet":
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for p in self.parameters():
                bound = 1.0 / math.sqrt(p[0].numel())
                p.copy_(torch.rand(p.shape, generator=gen) * 2 * bound - bound)
        return self

    def store_weights_in_compute_dtype(self) -> "StubNet":
        return self.to(self.dtype)

    def forward(self, audio: torch.Tensor, cnoise: torch.Tensor) -> torch.Tensor:
        h = self.inp(audio[:, None].to(self.dtype)) + self.emb(cnoise.to(self.dtype))[:, :, None]
        return self.out(torch.tanh(h) * torch.sigmoid(h))[:, 0].float()


def build(args) -> StubNet:
    n = args.network
    return StubNet(int(n.channels), torch.bfloat16 if str(n.get("compute_dtype")) == "bfloat16"
                   else torch.float32)
