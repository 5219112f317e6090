"""Which torch.distributed operations the gloo backend carries on CUDA
tensors when two ranks share one card (NCCL refuses two ranks on one
device).

    python -m aid_tpu_torch.tools.gloo_cuda_probe [--world 2]

For each operation, spawns ``--world`` ranks on ``cuda:0`` over gloo that
run it once and check its result; prints one line per operation (``ok``,
``wrong``, the error's first line, or ``rank died`` when gloo aborted the
process) and ends with a JSON object of the same. A probe
reports failures; the port never picks a route by catching one.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
from datetime import timedelta

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _ops(rank: int, world: int, dev: torch.device):
    """(name, thunk) pairs; each thunk returns True when the result is right."""
    import torch.distributed._functional_collectives as fc
    from torch.distributed.device_mesh import init_device_mesh

    def all_reduce():
        t = torch.full((4,), float(rank + 1), device=dev)
        dist.all_reduce(t)
        return bool((t == world * (world + 1) / 2).all())

    def broadcast():
        t = torch.full((4,), float(rank), device=dev)
        dist.broadcast(t, 0)
        return bool((t == 0).all())

    def all_gather():
        out = [torch.empty(3, device=dev) for _ in range(world)]
        dist.all_gather(out, torch.full((3,), float(rank), device=dev))
        return all(bool((o == i).all()) for i, o in enumerate(out))

    def all_gather_into_tensor():
        out = torch.empty(world * 3, device=dev)
        dist.all_gather_into_tensor(out, torch.full((3,), float(rank), device=dev))
        return bool((out.view(world, 3) == torch.arange(world, device=dev)[:, None]).all())

    def reduce_scatter_tensor():
        inp = torch.arange(world * 3, device=dev, dtype=torch.float32)
        out = torch.empty(3, device=dev)
        dist.reduce_scatter_tensor(out, inp)
        return bool((out == world * inp.view(world, 3)[rank]).all())

    def send_recv():
        peer = (rank + 1) % world
        src = (rank - 1) % world
        buf = torch.empty(5, device=dev)
        if rank % 2 == 0:
            dist.send(torch.full((5,), float(rank), device=dev), peer)
            dist.recv(buf, src)
        else:
            dist.recv(buf, src)
            dist.send(torch.full((5,), float(rank), device=dev), peer)
        return bool((buf == src).all())

    def batch_isend_irecv():
        peer = (rank + 1) % world
        src = (rank - 1) % world
        buf = torch.empty(5, device=dev)
        ops = [dist.P2POp(dist.isend, torch.full((5,), float(rank), device=dev), peer),
               dist.P2POp(dist.irecv, buf, src)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        return bool((buf == src).all())

    def all_to_all_single():
        inp = torch.full((world * 2,), float(rank), device=dev)
        out = torch.empty(world * 2, device=dev)
        dist.all_to_all_single(out, inp)
        return bool((out.view(world, 2) == torch.arange(world, device=dev)[:, None]).all())

    def fc_all_gather_autograd():
        x = torch.full((2, 3), float(rank), device=dev, requires_grad=True)
        y = fc.all_gather_tensor_autograd(x, 0, dist.group.WORLD)
        y = fc.wait_tensor(y) if hasattr(fc, "wait_tensor") else y
        y.sum().backward()
        return bool((x.grad == world).all()) and y.shape[0] == 2 * world

    def fc_all_reduce_autograd():
        x = torch.full((3,), float(rank + 1), device=dev, requires_grad=True)
        y = fc.all_reduce(x, "sum", dist.group.WORLD)
        y = fc.wait_tensor(y) if hasattr(fc, "wait_tensor") else y
        y.sum().backward()
        return x.grad is not None and bool((x.grad == world).all())

    def ddp_step():
        from torch.nn.parallel import DistributedDataParallel as DDP
        torch.manual_seed(0)
        m = DDP(torch.nn.Conv2d(4, 8, 3, padding=1).to(dev),
                device_ids=[dev.index] if dev.type == "cuda" else None)
        x = torch.full((1, 4, 6, 6), float(rank + 1), device=dev)
        m(x).sum().backward()
        g = m.module.weight.grad.clone()
        dist.all_reduce(g)
        return bool(torch.allclose(g / world, m.module.weight.grad))

    def fsdp2_step():
        from torch.distributed.fsdp import fully_shard
        mesh = init_device_mesh(dev.type, (world,))
        torch.manual_seed(0)
        m = torch.nn.Sequential(torch.nn.Linear(16, 32), torch.nn.Linear(32, 8)).to(dev)
        fully_shard(m, mesh=mesh)
        x = torch.full((2, 16), float(rank + 1), device=dev)
        m(x).sum().backward()
        return all(p.grad is not None for p in m.parameters())

    def fsdp2_placement_step():
        from torch.distributed.fsdp import fully_shard
        from torch.distributed.tensor import DTensor, Shard
        mesh = init_device_mesh(dev.type, (world,))
        torch.manual_seed(0)
        m = torch.nn.Sequential(torch.nn.Linear(16, 32), torch.nn.Linear(32, 8)).to(dev)
        small = {m[1].bias}
        fully_shard(m, mesh=mesh, shard_placement_fn=lambda p: Shard(p.dim() - 1),
                    ignored_params=small)
        m(torch.full((2, 16), float(rank + 1), device=dev)).sum().backward()
        return (isinstance(m[0].weight, DTensor) and not isinstance(m[1].bias, DTensor)
                and m[0].weight.to_local().shape[-1] == 16 // world)

    return [("all_reduce", all_reduce), ("broadcast", broadcast), ("all_gather", all_gather),
            ("all_gather_into_tensor", all_gather_into_tensor),
            ("reduce_scatter_tensor", reduce_scatter_tensor), ("send_recv", send_recv),
            ("batch_isend_irecv", batch_isend_irecv), ("all_to_all_single", all_to_all_single),
            ("functional all_gather_tensor_autograd", fc_all_gather_autograd),
            ("functional all_reduce backward", fc_all_reduce_autograd),
            ("DDP step", ddp_step), ("FSDP2 fully_shard step", fsdp2_step),
            ("FSDP2 shard_placement_fn + ignored_params", fsdp2_placement_step)]


def _worker(rank: int, world: int, rdv: str, out_dir: str, device: str, op: str) -> None:
    dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=60))
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    fn = dict(_ops(rank, world, dev))[op]
    try:
        ok = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        res = "ok" if ok else "wrong"
    except Exception as e:  # the probe reports what fails
        res = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


def _probe(op: str, world: int, device: str) -> str:
    """One operation in a fresh group of ``world`` ranks: a rank that dies
    (gloo aborts on some device pointers) takes only this probe with it."""
    with tempfile.TemporaryDirectory() as d:
        try:
            mp.spawn(_worker, args=(world, os.path.join(d, "rdv"), d, device, op),
                     nprocs=world)
        except mp.ProcessExitedException as e:
            return f"rank died: {str(e).splitlines()[0][:120]}"
        res = [json.load(open(os.path.join(d, f"rank{r}.json"))) for r in range(world)]
    return res[0] if len(set(res)) == 1 else " | ".join(res)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--device", default="cuda:0", help="cpu rehearses the probe")
    a = ap.parse_args()
    if a.device != "cpu":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device")
        print(torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0), flush=True)
    names = [name for name, _ in _ops(0, a.world, torch.device("cpu"))]
    res = {}
    for name in names:
        res[name] = _probe(name, a.world, a.device)
        print(f"{name:40s} {res[name]}", flush=True)
    print(json.dumps({"gloo": a.device, "world": a.world, "ops": res}))

if __name__ == "__main__":
    main()
