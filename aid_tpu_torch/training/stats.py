"""Training statistics: [n, sum, sum_sq] moment rows, computed on the device.

Port of ``aid_tpu/training/stats.py``. The moments of the per-sample loss and
the per-sigma-bin loss histogram are tensor reductions on the step's device
(a ``scatter_add`` over static bin edges, no host sync); under a process
group the trainer sums the rows over the ranks (``sum_over_ranks``), so they
describe the global batch as the JAX step's do; the host-side ``Collector``
turns the rows into per-interval mean and std.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch


def moments(x: torch.Tensor) -> torch.Tensor:
    """[n, sum, sum_sq] of a (possibly empty) tensor, f32."""
    f = x.reshape(-1).float()
    n = torch.full((), float(f.numel()), device=f.device)
    return torch.stack([n, f.sum(), (f * f).sum()])


def sigma_binned_moments(loss_per_sample: torch.Tensor, sigma: torch.Tensor,
                         bin_edges: torch.Tensor) -> torch.Tensor:
    """Per-sigma-bin loss moments.

    loss_per_sample: [B]; sigma: [B] or [B, 1]; bin_edges: [num_bins + 1]
    ascending. Returns [num_bins, 3] rows of [n, sum, sum_sq]. A sigma goes
    to bin searchsorted(edges, sigma, left) - 1, clipped to the range."""
    s = sigma.reshape(-1).float()
    loss = loss_per_sample.reshape(-1).float()
    edges = bin_edges.to(s.device, torch.float32)
    num_bins = edges.shape[0] - 1
    idx = (torch.searchsorted(edges, s, right=False) - 1).clamp(0, num_bins - 1)
    vals = torch.stack([torch.ones_like(loss), loss, loss * loss], dim=-1)
    out = torch.zeros(num_bins, 3, device=s.device)
    return out.index_add_(0, idx, vals)


def sum_over_ranks(tensors: List[torch.Tensor], group=None) -> List[torch.Tensor]:
    """Each tensor summed over the ranks of ``group``, in one all-reduce:
    per-rank moment rows become the global batch's."""
    from aid_tpu_torch.parallel import mesh as pmesh
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    pmesh.all_reduce(flat, group=group)
    return [f.reshape(t.shape) for f, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


def make_sigma_bins(sigma_min: float, sigma_max: float, num_bins: int) -> np.ndarray:
    """Log-spaced sigma bin edges."""
    return np.exp(np.linspace(np.log(sigma_min), np.log(sigma_max), num_bins + 1))


@dataclasses.dataclass
class Collector:
    """Host-side accumulator of moment rows between flushes."""
    _acc: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)

    def update(self, name: str, m) -> None:
        m = np.asarray(m, np.float64).reshape(-1, 3)
        self._acc[name] = self._acc.get(name, np.zeros(3)) + m.sum(axis=0)

    def update_binned(self, name: str, m) -> None:
        m = np.asarray(m, np.float64)
        self._acc[name] = self._acc.get(name, np.zeros_like(m)) + m

    def mean(self, name: str):
        m = self._acc.get(name)
        if m is None:
            return float("nan")
        if m.ndim == 1:
            return m[1] / max(m[0], 1.0)
        return m[:, 1] / np.maximum(m[:, 0], 1.0)

    def std(self, name: str):
        m = self._acc.get(name)
        if m is None:
            return float("nan")
        mm = m if m.ndim == 2 else m[None]
        n = np.maximum(mm[:, 0], 1.0)
        mean = mm[:, 1] / n
        out = np.sqrt(np.maximum(mm[:, 2] / n - mean ** 2, 0.0))
        return out if m.ndim == 2 else float(out[0])

    def names(self) -> List[str]:
        return list(self._acc)

    def flush(self) -> None:
        self._acc.clear()
