"""Process group, data-parallel mesh and FSDP placement over torch.distributed.

Port of ``aid_tpu/parallel/mesh.py``. One rank is one device. The global
batch (``exp.batch``) is split over a 1-D ``"dp"`` mesh of ranks; each rank
loads its share (``local_batch_size``) from its own data stream. Parameters
are replicated (DDP) or, with ``exp.mesh.fsdp``, sharded by FSDP2 after the
JAX package's ``fsdp_shardings`` rule (``fsdp_shard_dim``).

Backend: NCCL when every rank has its own card; gloo when ranks outnumber
the cards (NCCL refuses two ranks on one device) and when the caller names
the CPU. The choice follows from the launch environment and is printed.

What a CUDA graph can hold: NCCL's collectives (``captures_collectives``);
gloo stages CUDA tensors through the host, so its collectives cannot be
captured. Every collective of the step and the score goes through
``all_reduce`` / ``all_gather`` here, which raise (``guard``), naming the
backend, when a collective that cannot be captured is called while the
current stream captures. ``communicates`` says whether a network's forward
makes collectives at all (tp split layers, context parallelism).
"""
from __future__ import annotations

import os
import socket
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "dp"


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def choose_backend(device=None) -> Tuple[str, str]:
    """(backend, reason) for this launch: gloo when ``device`` names the CPU
    or when the ranks on this host (``LOCAL_WORLD_SIZE``) outnumber its
    cards, NCCL otherwise. Raises with no CUDA device and no explicit one."""
    if device is not None and torch.device(device).type == "cpu":
        return "gloo", "the caller named the CPU"
    n_cards = torch.cuda.device_count()
    if n_cards == 0:
        raise RuntimeError("aid_tpu_torch runs on a CUDA device; none is available "
                           "(pass device='cpu' to run on the CPU)")
    local = _env_int("LOCAL_WORLD_SIZE", _env_int("WORLD_SIZE", 1))
    if local > n_cards:
        return "gloo", (f"{local} ranks share {n_cards} card(s) and NCCL refuses two "
                        "ranks on one device")
    return "nccl", f"each of {local} rank(s) on this host has its own card"


def captures_collectives(group=None) -> bool:
    """Whether a CUDA graph can hold the collectives of ``group`` (the
    default group when None): NCCL's can; gloo's cannot."""
    return dist.get_backend(group) == "nccl"


def guard(group=None) -> None:
    """Raise before a collective of ``group`` that the capture in progress
    on the current CUDA stream cannot hold (a gloo collective would run on
    the host at capture time and never at replay). A build of torch
    without CUDA never captures."""
    capturing = torch.backends.cuda.is_built() and torch.cuda.is_current_stream_capturing()
    if capturing and not captures_collectives(group):
        raise RuntimeError(
            f"a {dist.get_backend(group)} collective was called while a CUDA graph is being "
            "captured; only NCCL's collectives can be captured")


def all_reduce(t: torch.Tensor, group=None, op=None) -> None:
    """``dist.all_reduce`` (a sum unless ``op``) behind ``guard``."""
    guard(group)
    dist.all_reduce(t, op=dist.ReduceOp.SUM if op is None else op, group=group)


def all_gather(parts: List[torch.Tensor], t: torch.Tensor, group=None) -> None:
    """``dist.all_gather`` behind ``guard``."""
    guard(group)
    dist.all_gather(parts, t, group=group)


def communicates(model) -> bool:
    """Whether a forward of ``model`` makes collectives now: a layer split
    over tp ranks (``parallel.tp.place_params`` gave it a ``tp_group``), or
    a context-parallel flag (``network.context_parallel``,
    ``attention_dict.context_parallel``) on any module while a cp mesh is
    installed (without one the flag changes nothing)."""
    from aid_tpu_torch.parallel import ring_attention as ring
    cp = ring.get_cp_mesh() is not None
    return any(getattr(m, "tp_group", None) is not None
               or (cp and getattr(m, "context_parallel", False)) for m in model.modules())


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_distributed(enable: bool = False, device=None) -> bool:
    """Start the process group; returns whether one is up.

    Runs when ``enable`` (``exp.mesh.distributed``), when
    ``AID_TPU_DISTRIBUTED=1`` or when the launcher's ``WORLD_SIZE`` is above
    1, reading ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``
    as ``torchrun`` sets them (``env://``); without a launcher it starts a
    one-rank group on a free localhost port. Safe to call twice. Under NCCL
    the rank's card becomes the current device."""
    if dist.is_initialized():
        return True
    forced = os.environ.get("AID_TPU_DISTRIBUTED", "") in ("1", "true", "True")
    if not (enable or forced or _env_int("WORLD_SIZE", 1) > 1):
        return False
    backend, reason = choose_backend(device)
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, init_method=f"tcp://localhost:{_free_port()}",
                                rank=0, world_size=1)
    from aid_tpu_torch.setup import resolve_device
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    print(f"[mesh] torch.distributed up: rank {dist.get_rank()}/{dist.get_world_size()}, "
          f"backend {backend} ({reason})", flush=True)
    return True


def mesh_size(n_dp: int, world: int, batch: Optional[int] = None) -> int:
    """Ranks of the dp mesh, by the JAX package's rules: ``n_dp`` <= 0 means
    every rank, else the first ``n_dp``; with ``batch`` it is clamped to the
    largest count that divides the global batch."""
    n = world if n_dp is None or n_dp <= 0 else min(int(n_dp), world)
    if batch is not None:
        while n > 1 and batch % n:
            n -= 1
    return n


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def dp_ranks(n_dp: int, world: int, batch: Optional[int] = None) -> int:
    """``mesh_size``, which must take every rank: a smaller mesh would leave
    ranks without rows, so that raises and names the rank count to launch."""
    n = mesh_size(n_dp, world, batch)
    if n != world:
        raise ValueError(
            f"a dp mesh of {n} rank(s) (exp.mesh.dp={n_dp}, global batch {batch}) leaves "
            f"ranks {n}..{world - 1} of {world} without work; launch {n} rank(s)")
    return n


def make_mesh(n_dp: int = -1, batch: Optional[int] = None, device_type: Optional[str] = None):
    """1-D ``"dp"`` DeviceMesh over every rank of the process group
    (``dp_ranks``)."""
    from torch.distributed.device_mesh import init_device_mesh
    n = dp_ranks(n_dp, world_size(), batch)
    return init_device_mesh(device_type or _device_type(), (n,), mesh_dim_names=(DATA_AXIS,))


def make_grid(n_major: int, n_minor: int, names: Tuple[str, str],
              device_type: Optional[str] = None):
    """2-D DeviceMesh of ``names`` over n_major x n_minor ranks, the second
    dim the minor one (its groups are runs of consecutive ranks). The world
    must hold exactly that many ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    world = world_size()
    if n_major * n_minor != world:
        raise ValueError(f"a {names[0]}={n_major} x {names[1]}={n_minor} mesh needs "
                         f"{n_major * n_minor} ranks; the world has {world}")
    return init_device_mesh(device_type or _device_type(), (n_major, n_minor),
                            mesh_dim_names=names)


def dim_size(mesh, name: str) -> int:
    """Size of ``mesh``'s dim ``name`` (1 when it has none)."""
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(name)) if name in names else 1


def _device_type() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def local_batch_size(global_batch: int, n_dp: int) -> int:
    """This rank's share of the global batch on a dp mesh of ``n_dp`` ranks."""
    if global_batch % n_dp:
        raise ValueError(f"global batch {global_batch} not divisible by mesh size {n_dp}")
    return global_batch // n_dp


def fsdp_shard_dim(shape: Sequence[int], n: int, min_size: int = 2 ** 14) -> Optional[int]:
    """The dim FSDP shards a tensor of ``shape`` on over ``n`` ranks: the
    largest one divisible by ``n`` (the first of equals); None (replicated)
    for tensors under ``min_size`` elements, with no such dim, or n <= 1."""
    numel = 1
    for d in shape:
        numel *= int(d)
    if n <= 1 or not shape or numel < min_size:
        return None
    best = None
    for i, d in enumerate(shape):
        if d % n == 0 and (best is None or d > shape[best]):
            best = i
    return best


def gather_to_host(tensors: Sequence[torch.Tensor], dims: Sequence[Optional[int]],
                   group=None, dst: int = 0) -> Optional[List[torch.Tensor]]:
    """Full CPU tensors on rank ``dst`` (None on the others) from per-rank
    pieces: a tensor with dim d is this rank's shard along d (gathered in
    rank order), one with None is replicated. Every rank of ``group`` calls
    it. One all-gather per sharded tensor, at checkpoint cadence."""
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    out = []
    for t, d in zip(tensors, dims):
        if d is not None:
            parts = [torch.empty_like(t) for _ in range(n)]
            dist.all_gather(parts, t.contiguous(), group=group)
            t = torch.cat(parts, dim=d) if me == dst else None
        out.append(None if t is None else t.detach().cpu())
    return out if me == dst else None
