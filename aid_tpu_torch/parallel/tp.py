"""Tensor-parallel (Megatron-style) split of the denoiser's conv and dense
layers over a ``"tp"`` mesh dim (port of ``aid_tpu/parallel/tp.py``).

``place_params`` keeps, on each rank of a tp group, only its slice of the
output channels of every conv and dense weight (dim 0 of the torch weight,
the last dim of the JAX kernel); everything else stays replicated. A split
layer computes its channel slice from the full input and all-gathers the
slices along C, so the norms, the fused kernel and every other op see full
channels, as on one device.

Both collectives are ``autograd.Function``s, so the guided score's input
gradient is the one-device gradient on every rank: the gather's backward
takes this rank's slice of the (replicated) output gradient, and the input
copy's backward sums the slices' input gradients over the group. (The
functional collectives' all-gather differentiates to a reduce-scatter, the
gradient of the sum of every rank's loss, which is tp times the replicated
network's gradient.) int8 serving does not compose with tp; ``shard`` raises
for it.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist

from aid_tpu_torch.parallel import mesh as pmesh

MODEL_AXIS = "tp"


def make_tp_mesh(n_tp: int, n_dp: int = 1, device_type=None):
    """2-D ("dp", "tp") DeviceMesh over n_dp x n_tp ranks, tp the minor dim,
    so a tp group is a run of consecutive ranks."""
    from aid_tpu_torch.parallel.mesh import DATA_AXIS, make_grid
    return make_grid(n_dp, n_tp, (DATA_AXIS, MODEL_AXIS), device_type)


def _splits(module, n_tp: int):
    """(name, layer) of every split layer: the model's conv and dense layers
    (``tp_split``) whose weight's output channels divide by ``n_tp``."""
    for name, m in module.named_modules():
        w = getattr(m, "weight", None)
        if (getattr(m, "tp_split", False) and n_tp > 1 and w is not None and w.dim() >= 2
                and w.shape[0] % n_tp == 0):
            yield name, m


def param_placements(module, n_tp: int) -> Dict[str, str]:
    """{parameter name: "shard0" or "replicate"}: the weights of the split
    layers are split on dim 0, every other parameter is replicated."""
    split = {f"{name}.weight" if name else "weight" for name, _ in _splits(module, n_tp)}
    return {n: "shard0" if n in split else "replicate" for n, _ in module.named_parameters()}


def place_params(module, mesh):
    """Keep this rank's output-channel slice of every split layer's weight
    and hand the layer the tp group; returns ``module``."""
    group = mesh.get_group(MODEL_AXIS)
    n, r = dist.get_world_size(group), dist.get_rank(group)
    with torch.no_grad():
        for _, m in list(_splits(module, n)):
            m.weight.data = m.weight.data.chunk(n, 0)[r].clone()
            m.tp_group = group
    return module


def local_slice(t: torch.Tensor, group) -> torch.Tensor:
    """This rank's block of ``t``'s dim 0 (a replicated bias of a split layer)."""
    return t.chunk(dist.get_world_size(group), 0)[dist.get_rank(group)]


class _CopyIn(torch.autograd.Function):
    """Identity; the backward sums the input gradient over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        pmesh.all_reduce(g, group=ctx.group)
        return g, None


class _GatherOut(torch.autograd.Function):
    """All-gather the last dim in rank order; the backward keeps this rank's
    block of the output gradient."""

    @staticmethod
    def forward(ctx, y, group):
        ctx.group, ctx.width = group, y.shape[-1]
        parts = [torch.empty_like(y) for _ in range(dist.get_world_size(group))]
        pmesh.all_gather(parts, y.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        r, w = dist.get_rank(ctx.group), ctx.width
        return g[..., r * w:(r + 1) * w].contiguous(), None


def split_apply(x: torch.Tensor, group, local_fn) -> torch.Tensor:
    """``local_fn`` gives this rank's output channels (the last dim) of a
    split layer; returns all of them."""
    return _GatherOut.apply(local_fn(_CopyIn.apply(x, group)), group)
