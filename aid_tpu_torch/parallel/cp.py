"""Full-score context parallelism: the denoiser's frame-time axis split over
the ranks of a ``"cp"`` mesh dim (``network.context_parallel``).

The JAX package pins the time axis of every ``[B, F, T, C]`` activation to
the cp mesh axis and lets GSPMD derive the exchanges
(``aid_tpu/models/unet_cqt.py`` ``_cp_constrain``). Here they are written
out, each a ``torch.autograd.Function``, because guided sampling
differentiates the score through all of them:

  * ``shard`` takes a replicated tensor to this rank's ``T/n`` block; its
    backward all-gathers the block gradients (the replicated CQT before it
    wants the whole input gradient on every rank);
  * ``gather`` takes the blocks to the whole tensor; its backward is this
    rank's slice of the incoming gradient (the loss after ``cqt.bwd`` is
    replicated, so a reduce-scatter would count it n times);
  * ``halo`` gives this rank its neighbours' boundary frames (zeros at the
    global edges) for the (5, 3) convs (1 frame) and the FIR resamplers
    (3 frames, what the cubic filter needs down; up needs 2; reflected at
    the global edges from the edge rank's own frames);
  * ``all_reduce`` sums the group-norm moments; its backward sums the
    partial gradients.

Attention runs the ring in its local mode (``ring_attention(...,
local=True)``). A level whose ``T`` the cp size does not divide, or whose
block is shorter than the widest halo, runs replicated, as in JAX.

Route. gloo sends no CUDA tensor point to point (``tools/gloo_cuda_probe.py``),
so a halo is one ``all_gather`` of every rank's boundary frames, from which
each rank picks its neighbours', and its backward one ``all_gather`` of the
halo gradients: one code path for gloo and NCCL.

Only the input gradient is complete on every rank. Parameter gradients
under a cp mesh are each rank's partial sums over its own frames; nothing
asks for them (training installs no cp mesh).
"""
from __future__ import annotations

import collections
from typing import List, Optional

import torch
import torch.distributed as dist

from aid_tpu_torch.parallel import mesh as pmesh
from aid_tpu_torch.parallel import ring_attention as ring

# The widest halo (the cubic FIR's 3 frames) and the edge frame that a
# reflect skips: a rank's block must hold at least this many frames for its
# level to shard.
MIN_BLOCK = 4

# Collectives and levels of the sharded forwards (and their backwards) since
# ``reset_counts``: "halo" and "halo_bwd" exchanges, "shard", "gather",
# "moments" all-reduces, "ring" attention layers, "levels_sharded" and
# "levels_replicated" (one per U-Net level per forward).
_counts: collections.Counter = collections.Counter()


def counts() -> dict:
    return dict(_counts)


def reset_counts() -> None:
    _counts.clear()


def _all_gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    pmesh.all_gather(parts, t.contiguous(), group=group)
    return parts


class _Shard(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        n, r = dist.get_world_size(group), dist.get_rank(group)
        ctx.group = group
        Tb = x.shape[2] // n
        return x[:, :, r * Tb:(r + 1) * Tb].contiguous()

    @staticmethod
    def backward(ctx, g):
        return torch.cat(_all_gather(g, ctx.group), dim=2), None


class _Gather(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.Tb = group, x.shape[2]
        return torch.cat(_all_gather(x, group), dim=2)

    @staticmethod
    def backward(ctx, g):
        r, Tb = dist.get_rank(ctx.group), ctx.Tb
        return g[:, :, r * Tb:(r + 1) * Tb].contiguous(), None


class _AllReduce(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        pmesh.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        pmesh.all_reduce(g, group=ctx.group)
        return g, None


class _Halo(torch.autograd.Function):
    """(left, right): the h frames before and after this rank's block along
    dim 2, zeros beyond the global edges. One all-gather of every rank's
    first and last h frames; the backward all-gathers the halo gradients
    and adds the two that belong to this rank's own boundary frames."""

    @staticmethod
    def forward(ctx, x, h, group):
        n, r = dist.get_world_size(group), dist.get_rank(group)
        ctx.h, ctx.group, ctx.shape = h, group, x.shape
        parts = _all_gather(torch.cat([x[:, :, :h], x[:, :, -h:]], dim=2), group)
        zeros = torch.zeros_like(parts[0][:, :, :h])
        left = parts[r - 1][:, :, h:] if r > 0 else zeros
        right = parts[r + 1][:, :, :h] if r < n - 1 else zeros.clone()
        return left, right

    @staticmethod
    def backward(ctx, gl, gr):
        h, group = ctx.h, ctx.group
        n, r = dist.get_world_size(group), dist.get_rank(group)
        _counts["halo_bwd"] += 1
        parts = _all_gather(torch.cat([gl, gr], dim=2), group)
        dx = gl.new_zeros(ctx.shape)
        if r > 0:        # rank r-1's right halo is my first h frames
            dx[:, :, :h] += parts[r - 1][:, :, h:]
        if r < n - 1:    # rank r+1's left halo is my last h frames
            dx[:, :, -h:] += parts[r + 1][:, :, :h]
        return dx, None, None


class ContextParallel:
    """This rank's place in a cp group, and the sharded forms of the
    denoiser's time-axis operations. ``from_mesh`` gives one for an
    installed mesh whose cp dim has more than one rank, else None."""

    def __init__(self, group):
        self.group = group
        self.n = dist.get_world_size(group)
        self.rank = dist.get_rank(group)

    @classmethod
    def from_mesh(cls, mesh) -> Optional["ContextParallel"]:
        if mesh is None or mesh[ring.CP_AXIS].size() <= 1:
            return None
        return cls(mesh.get_group(ring.CP_AXIS))

    def can_shard(self, T: int) -> bool:
        return T % self.n == 0 and T // self.n >= MIN_BLOCK

    def note_level(self, sharded: bool) -> None:
        _counts["levels_sharded" if sharded else "levels_replicated"] += 1

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        _counts["shard"] += 1
        return _Shard.apply(x, self.group)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        _counts["gather"] += 1
        return _Gather.apply(x, self.group)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        _counts["moments"] += 1
        return _AllReduce.apply(x, self.group)

    def pad_time(self, x: torch.Tensor, h: int, reflect: bool = False) -> torch.Tensor:
        """This rank's block of ``x`` [B, F, T/n, C] with h frames of its
        neighbours on each side: zeros beyond the global edges (SAME
        padding), or with ``reflect`` the edge rank's own frames mirrored
        (the resampler's reflect padding)."""
        _counts["halo"] += 1
        left, right = _Halo.apply(x, h, self.group)
        if reflect and self.rank == 0:
            left = x[:, :, 1:h + 1].flip(2)
        if reflect and self.rank == self.n - 1:
            right = x[:, :, -h - 1:-1].flip(2)
        return torch.cat([left, x, right], dim=2)

    def ring_attention(self, q, k, v, bias, scale):
        """Attention of this rank's query block over every rank's keys:
        q, k, v [B, H, T/n, D] local, bias [.., T/n, T] (this block's rows)."""
        _counts["ring"] += 1
        return ring.ring_attention(q, k, v, self.group, bias=bias, scale=scale, local=True)
