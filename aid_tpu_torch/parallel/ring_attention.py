"""Context-parallel (ring) attention over the time axis (port of
``aid_tpu/parallel/ring_attention.py``).

``ring_attention`` takes the full q, k, v (and bias) on every rank of a cp
group and returns the full output on every rank. Rank r computes the query
rows of its T/n block: its K/V block travels the ring (``batch_isend_irecv``
to rank r-1, from rank r+1), and each block received is folded into a
running row max and denominator in f32, so the result is the dense softmax
attention up to f32 reassociation. The backward (an ``autograd.Function``;
guided sampling differentiates through the denoiser) recomputes each
block's probabilities from the saved log-sum-exp, sends K/V around the ring
again with their dK/dV accumulators beside them, and one last hop brings
every block's dK/dV home. The pieces are all-gathered, so every rank
returns the whole gradient, as the replicated network around it expects.
Matmuls and softmax are plain torch ops. In its local mode (full-score
context parallelism, ``parallel.cp``) q, k, v and the output stay this
rank's blocks, and nothing is all-gathered.

``TimeAttention`` with ``attention_dict.context_parallel`` uses it when a
mesh with a ``"cp"`` dim is installed (``set_cp_mesh``).
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

from aid_tpu_torch.parallel import mesh as pmesh

CP_AXIS = "cp"


def _dense(q, k, v, bias, scale):
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.float()
    return torch.matmul(torch.softmax(s, dim=-1), v.float()).to(q.dtype)


def _gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    pmesh.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


_STAGED_SAID = False


def _hop(tensors: List[torch.Tensor], group, to: int, frm: int):
    """Start sending ``tensors`` to global rank ``to`` and receiving as many
    of the same shapes from ``frm``; returns a function that waits and gives
    the received tensors. gloo sends no CUDA tensor point to point (it
    reads the device pointer as a host one), so a gloo group, which ranks
    sharing one card use, stages the blocks through host memory, as gloo
    itself does for its collectives on CUDA tensors."""
    global _STAGED_SAID
    pmesh.guard(group)
    dev = tensors[0].device
    staged = dev.type == "cuda" and dist.get_backend(group) == "gloo"
    if staged:
        if not _STAGED_SAID:
            print("[ring] gloo group on CUDA tensors: K/V hops staged through host memory",
                  flush=True)
            _STAGED_SAID = True
        tensors = [t.cpu() for t in tensors]
    bufs = [torch.empty_like(t) for t in tensors]
    reqs = dist.batch_isend_irecv(
        [dist.P2POp(dist.isend, t, to, group) for t in tensors]
        + [dist.P2POp(dist.irecv, b, frm, group) for b in bufs])

    def finish() -> List[torch.Tensor]:
        for req in reqs:
            req.wait()
        return [b.to(dev) for b in bufs] if staged else bufs
    return finish


class _RingAttention(torch.autograd.Function):
    """One body for both modes: ``local`` False takes whole q, k, v and
    bias on every rank and returns the whole output (each rank computes its
    T/n query rows, then all-gathers); ``local`` True takes this rank's
    block of q, k, v and the bias rows of its queries ([.., T/n, T]) and
    returns its block of the output, with gradients of the same shapes."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale, group, local):
        n, r = dist.get_world_size(group), dist.get_rank(group)
        Tb = q.shape[2] if local else q.shape[2] // n
        rows = slice(0, Tb) if local else slice(r * Tb, (r + 1) * Tb)
        to = dist.get_global_rank(group, (r - 1) % n)
        frm = dist.get_global_rank(group, (r + 1) % n)
        ql = q[:, :, rows].float()
        kb, vb = k[:, :, rows].float().contiguous(), v[:, :, rows].float().contiguous()
        bl = None if bias is None else bias[:, :, rows].float()
        m = torch.full(ql.shape[:3], -torch.inf, device=q.device)
        l = torch.zeros_like(m)
        o = torch.zeros(ql.shape[:3] + vb.shape[3:], device=q.device)
        for step in range(n):
            src = (r + step) % n   # the block now held started on rank src
            if step < n - 1:
                nxt = _hop([kb, vb], group, to, frm)
            s = torch.matmul(ql, kb.transpose(-1, -2)) * scale
            if bl is not None:
                s = s + bl[..., src * Tb:(src + 1) * Tb]
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            o = o * corr[..., None] + torch.matmul(p, vb)
            m = m_new
            if step < n - 1:
                kb, vb = nxt()
        out = o / l[..., None]
        ctx.save_for_backward(q, k, v, bias, out, m + torch.log(l))
        ctx.scale, ctx.group, ctx.local = scale, group, local
        return out.to(q.dtype) if local else _gather(out.to(q.dtype), group, 2)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, out, lse = ctx.saved_tensors
        scale, group, local = ctx.scale, ctx.group, ctx.local
        n, r = dist.get_world_size(group), dist.get_rank(group)
        Tb = q.shape[2] if local else q.shape[2] // n
        rows = slice(0, Tb) if local else slice(r * Tb, (r + 1) * Tb)
        to = dist.get_global_rank(group, (r - 1) % n)
        frm = dist.get_global_rank(group, (r + 1) % n)
        ql = q[:, :, rows].float()
        kb, vb = k[:, :, rows].float().contiguous(), v[:, :, rows].float().contiguous()
        bl = None if bias is None else bias[:, :, rows].float()
        do = dout[:, :, rows].float()
        delta = (do * out).sum(-1, keepdim=True)
        dq = torch.zeros_like(ql)
        dkb, dvb = torch.zeros_like(kb), torch.zeros_like(vb)
        want_db = bias is not None and ctx.needs_input_grad[3]
        dbl = torch.zeros(bl.shape, device=q.device) if want_db else None
        for step in range(n):
            src = (r + step) % n
            cols = slice(src * Tb, (src + 1) * Tb)
            s = torch.matmul(ql, kb.transpose(-1, -2)) * scale
            if bl is not None:
                s = s + bl[..., cols]
            p = torch.exp(s - lse[..., None])
            dvb = dvb + torch.matmul(p.transpose(-1, -2), do)
            ds = p * (torch.matmul(do, vb.transpose(-1, -2)) - delta)
            if want_db:
                dbl[..., cols] = ds.sum(0, keepdim=True) if bl.shape[0] == 1 else ds
            dq = dq + torch.matmul(ds, kb) * scale
            dkb = dkb + torch.matmul(ds.transpose(-1, -2), ql) * scale
            # the accumulators travel with their block; the last hop takes
            # them home (the block itself is no longer needed)
            got = _hop([dkb, dvb] if step == n - 1 else [kb, vb, dkb, dvb], group, to, frm)()
            if step == n - 1:
                dkb, dvb = got
            else:
                kb, vb, dkb, dvb = got
        grads = [dq.to(q.dtype), dkb.to(k.dtype), dvb.to(v.dtype),
                 dbl.to(bias.dtype) if want_db else None]
        if not local:
            grads = [None if g is None else _gather(g, group, 2) for g in grads]
        return (*grads, None, None, None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group=None,
                   bias: Optional[torch.Tensor] = None,
                   scale: Optional[float] = None, local: bool = False) -> torch.Tensor:
    """softmax(q k^T * scale + bias) v with T split over the ranks of
    ``group`` (the default group when None).

    q, k, v: [B, H, T, D], the same on every rank, T divisible by the group
    size; bias: [1 or B, H, T, T] or None; scale defaults to D^-0.5. Returns
    [B, H, T, D] in q's dtype on every rank; differentiable in q, k, v and
    bias. One rank computes the dense attention.

    ``local``: q, k, v are this rank's [B, H, T/n, D] blocks of a time axis
    split in rank order, bias the [.., T/n, T] rows of its queries; returns
    this rank's [B, H, T/n, D] block (full-score context parallelism,
    ``parallel.cp``)."""
    if scale is None:
        scale = float(q.shape[-1]) ** -0.5
    n = dist.get_world_size(group) if dist.is_initialized() else 1
    if n == 1:
        return _dense(q, k, v, bias, scale)
    if not local and q.shape[2] % n:
        raise ValueError(f"T={q.shape[2]} is not divisible by the cp size {n}")
    return _RingAttention.apply(q, k, v, bias, float(scale), group or dist.group.WORLD,
                                bool(local))


# ---------------------------------------------------------------------------
# The installed context-parallel mesh: TimeAttention reads it at call time
# when the network config asks for context parallelism.

_CP_MESH = None


def set_cp_mesh(mesh) -> None:
    """Install (or clear, with None) the DeviceMesh whose ``"cp"`` dim
    splits attention's time axis."""
    global _CP_MESH
    if mesh is not None and CP_AXIS not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"mesh has no '{CP_AXIS}' dim: {mesh.mesh_dim_names}")
    _CP_MESH = mesh


def get_cp_mesh():
    return _CP_MESH


def make_cp_mesh(n_cp: int, n_dp: int = 1, device_type: Optional[str] = None):
    """2-D ("dp", "cp") DeviceMesh over n_dp x n_cp ranks, cp the minor dim
    (ranks r and r+1 are ring neighbours). The world must hold exactly that
    many ranks."""
    from aid_tpu_torch.parallel.mesh import DATA_AXIS, make_grid
    return make_grid(n_dp, n_cp, (DATA_AXIS, CP_AXIS), device_type)
