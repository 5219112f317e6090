"""Ranks of a CPU process group for tests/test_torch_parallel.py.

    python -m tests.torch_dist_worker JOB RANK WORLD WORKDIR

Each rank joins a gloo group through ``file://WORKDIR/rdv``, reads the
job's inputs from ``WORKDIR/in.pt`` (written by the test), runs the job and
writes ``WORKDIR/out{RANK}.pt``. It imports torch and the port only: the
test process holds the JAX package and its eight fake XLA devices, so the
JAX references are computed there, while the ranks run (``Group``).
"""
from __future__ import annotations

import os
import subprocess
import sys
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Group:
    """``world`` ranks running ``job`` in the background; ``results()``
    waits for them and returns their outputs in rank order. A rank that
    fails fails the group with its output."""

    def __init__(self, job: str, world: int, workdir: str, inputs: dict,
                 timeout: float = 300):
        os.makedirs(workdir, exist_ok=True)
        torch.save(inputs, os.path.join(workdir, "in.pt"))
        env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
                   OPENBLAS_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
        self.job, self.workdir, self.timeout = job, workdir, timeout
        self.procs = [subprocess.Popen([sys.executable, "-m", "tests.torch_dist_worker", job,
                                        str(r), str(world), workdir], cwd=ROOT, env=env,
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
                      for r in range(world)]

    def results(self):
        logs = []
        try:
            for p in self.procs:
                logs.append(p.communicate(timeout=self.timeout)[0])
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, log) in enumerate(zip(self.procs, logs)):
            if p.returncode != 0:
                raise RuntimeError(f"{self.job} rank {r} exited {p.returncode}:\n{log[-6000:]}")
        return [torch.load(os.path.join(self.workdir, f"out{r}.pt"), weights_only=False)
                for r in range(len(self.procs))]


# ------------------------------------------------------------------ training


def _trainer(inp, extra, model_dir):
    from aid_tpu_torch import setup as tsetup
    from aid_tpu_torch.utils.config import compose
    args = compose(overrides=list(inp["overrides"]) + list(extra) + [f"model_dir={model_dir}"])
    net = tsetup.setup_network(args, device="cpu", state_dict=inp["state_dict"], seed=1,
                               trainable=True)
    tr = tsetup.setup_trainer(args, network=net, diff_params=tsetup.setup_diff_parameters(args))
    return tr


def _rows(a, rank, world):
    """This rank's rows of every micro-batch of a global host array."""
    k = a.shape[1] // world
    return a[:, rank * k:(rank + 1) * k]


def _local(step, rank, world):
    """This rank's host audio [n_accum k, T], fs and draws of a global step
    (audio [n_accum, B, T], fs [n_accum, B], draws per micro-batch)."""
    audio, fs, draws = step
    n_accum = audio.shape[0]
    audio, fs = _rows(audio, rank, world), _rows(fs, rank, world)
    k = audio.shape[1]
    mine = [{n: v[rank * k:(rank + 1) * k] for n, v in d.items()} for d in draws]
    return audio.reshape(n_accum * k, -1), fs.reshape(-1), mine


def _local_step(tr, step, rank, world, program=None):
    """One step on this rank's rows and draws of a global step: as
    ``train_step`` runs it, or through the step program (``program``
    True) or eagerly (False)."""
    if program is None:
        return tr.train_step(*_local(step, rank, world))
    return tr._train_step(*_local(step, rank, world), program)


class _Capturing:
    """Within it, the current CUDA stream reads as capturing (on the CPU)."""

    def __enter__(self):
        self.saved = torch.backends.cuda.is_built, torch.cuda.is_current_stream_capturing
        torch.backends.cuda.is_built = torch.cuda.is_current_stream_capturing = lambda: True

    def __exit__(self, *exc):
        torch.backends.cuda.is_built, torch.cuda.is_current_stream_capturing = self.saved


def _raised(fn):
    """The message ``fn()`` raised RuntimeError with, or "no error"."""
    try:
        fn()
    except RuntimeError as e:
        return str(e)
    return "no error"


def _dp_pieces_capturing(tr, step, rank, world):
    """The dp step program's three pieces with the stream reading as
    capturing: what each raised (the state is put back after)."""
    restore = tr._snapshot()
    x, d = tr._inputs(*tr._split(*_local(step, rank, world)[:2]), _local(step, rank, world)[2])
    keep = torch.tensor(0.5)
    got = {}
    with _Capturing():
        flat = []
        got["head"] = _raised(lambda: flat.append(tr._dp_head(x, d)))
        got["reduce"] = _raised(lambda: tr._dp_reduce(flat[0]))
        got["tail"] = _raised(lambda: tr._dp_tail(flat[0], keep))
    restore()
    return got


def _metrics(m):
    return {k: (v.detach().cpu().numpy() if torch.is_tensor(v) else
                {n: t.detach().cpu().numpy() for n, t in v.items()}) for k, v in m.items()}


def job_train(inp, rank, world, workdir):
    """dp (DDP) and fsdp (FSDP2) runs of the given steps; a DDP run with two
    micro-batches a step; an fsdp run saved at step 2; a world-1 checkpoint
    resumed under fsdp for the last step."""
    out = {}
    for mode, extra, program in (("dp", ["exp.mesh.dp=2"], False),
                                 ("dp_program", ["exp.mesh.dp=2"], True),
                                 ("fsdp", inp["fsdp"], None)):
        tr = _trainer(inp, extra, os.path.join(workdir, mode))
        tr.init_state()
        out[mode] = {"wrapper": type(tr.model).__name__,
                     "metrics": [_metrics(_local_step(tr, s, rank, world, program))
                                 for s in inp["steps"]],
                     "state": tr.state_dict(), "programs_enabled": tr.programs_enabled(),
                     "step_programs_built": tr.step_programs_built}
        if mode == "dp_program":
            out[mode]["capturing"] = _dp_pieces_capturing(tr, inp["steps"][0], rank, world)
        if mode == "fsdp":
            out[mode]["local_fraction"] = {
                k: [t.numel() / int(np.prod(s)) for t, s in zip(ts, tr.shapes)]
                for k, ts in (("params", tr.params), ("ema", tr.ema), ("mu", tr.mu),
                              ("nu", tr.nu))}
            out[mode]["shard_dims"] = tr.shard_dims
    # gradient accumulation: DDP syncs on the last micro-batch only
    for name, program in (("dp_accumulate2", False), ("dp_accumulate2_program", True)):
        tr = _trainer(inp, ["exp.mesh.dp=2", "exp.num_accumulation_rounds=2"],
                      os.path.join(workdir, name))
        tr.init_state()
        out[name] = {"metrics": [_metrics(_local_step(tr, s, rank, world, program))
                                 for s in inp["accumulate_steps"]],
                     "state": tr.state_dict(), "step_programs_built": tr.step_programs_built}
    tr = _trainer(inp, inp["fsdp"], os.path.join(workdir, "saved"))
    tr.init_state()
    for s in inp["steps"][:2]:
        _local_step(tr, s, rank, world)
    out["saved_at_2"] = tr.save_checkpoint()
    tr = _trainer(inp, inp["fsdp"], os.path.join(workdir, "resumed"))
    assert tr.resume_from_checkpoint(inp["world1_checkpoint"])
    _local_step(tr, inp["steps"][2], rank, world)
    out["resumed_from_world1"] = tr.state_dict()
    return out


# ----------------------------------------------- attention, tp, dp serving


def _unet(attention, state_dict):
    from aid_tpu_torch.models import unet_cqt as tunet
    from aid_tpu_torch.ops.cqt import get_cqt
    c = attention["net"]
    net = tunet.UnetCQT(get_cqt(c["O"], c["bins"], c["fs"], c["len"]), c["Ns"], c["num_dils"],
                        c["att_layers"], attention["attn"], emb_dim=c["emb"], gelu=c["gelu"])
    net.load_state_dict(state_dict)
    return net.requires_grad_(False)


def _guided_score(net, p, x, y, mask, t):
    from aid_tpu_torch.diffusion import edm
    from aid_tpu_torch.sampling import degradations as degr
    from aid_tpu_torch.sampling.heun import SamplerConfig, make_score_fn
    yt, mt = torch.from_numpy(y), torch.from_numpy(mask)
    score = make_score_fn(p, SamplerConfig(), lambda a, s: edm.denoiser(p, net, a, s.reshape(1, 1)),
                          y=yt, degradation=degr.time_mask(mt),
                          proj=degr.inpainting_projector(yt, mt), hpf=net.cqt.apply_hpf_DC)
    return score(torch.from_numpy(x), torch.tensor(t)).numpy()


def job_attention(inp, rank, world, workdir):
    """Ring attention (forward and gradients), the U-Net with cp attention
    (forward and input gradient), the tp=2 U-Net (forward and guided score)
    and a dp=2 served request."""
    from aid_tpu_torch.diffusion import edm
    from aid_tpu_torch.parallel import mesh as pmesh
    from aid_tpu_torch.parallel import ring_attention as ring
    from aid_tpu_torch.parallel import tp
    out = {}
    r = inp["ring"]
    q, k, v, bias = (torch.from_numpy(r[n]).requires_grad_(True) for n in ("q", "k", "v", "bias"))
    y = ring.ring_attention(q, k, v, None, bias=bias)
    torch.sin(y).sum().backward()
    out["ring"] = {"y": y.detach().numpy(), "dq": q.grad.numpy(), "dk": k.grad.numpy(),
                   "dv": v.grad.numpy(), "dbias": bias.grad.numpy()}

    c = inp["cp"]
    calls = []
    dense_ring = ring.ring_attention

    def counted(*a, **kw):
        calls.append(a[0].shape[2])
        return dense_ring(*a, **kw)

    ring.ring_attention = counted
    cp_net = _unet(c, c["state_dict"])
    x = torch.from_numpy(c["audio"]).requires_grad_(True)
    ring.set_cp_mesh(ring.make_cp_mesh(world, device_type="cpu"))
    try:
        ycp = cp_net(x, torch.from_numpy(c["cnoise"]))
        (ycp * torch.from_numpy(c["w"])).sum().backward()
    finally:
        ring.set_cp_mesh(None)
        ring.ring_attention = dense_ring
    out["cp"] = {"y": ycp.detach().numpy(), "dx": x.grad.numpy(), "ring_T": calls}

    t = inp["tp"]
    net = _unet(t, t["state_dict"])
    mesh = tp.make_tp_mesh(world, device_type="cpu")
    tp.place_params(net, mesh)
    with torch.no_grad():
        ytp = net(torch.from_numpy(t["audio"]), torch.from_numpy(t["cnoise"]))
    p = edm.EDMParams(**t["edm"])
    out["tp"] = {"y": ytp.numpy(),
                 "score": _guided_score(net, p, t["x"], t["y"], t["mask"], t["t"]),
                 "placements": tp.param_placements(net, world),
                 "local_fraction": {n: q.shape[0] for n, q in net.named_parameters()}}

    out["serve_dp"] = _serve(inp["serve"], pmesh.make_mesh(device_type="cpu"))[0]
    out["capturing"] = _collectives_capturing()
    return out


def _collectives_capturing():
    """What each of the port's collectives over this gloo group raised with
    the stream reading as capturing."""
    from aid_tpu_torch.parallel import mesh as pmesh
    from aid_tpu_torch.parallel import ring_attention as ring
    from aid_tpu_torch.training import stats as tstats
    t = torch.ones(4)
    with _Capturing():
        return {"all_reduce": _raised(lambda: pmesh.all_reduce(t)),
                "all_gather": _raised(lambda: pmesh.all_gather([t.clone(), t.clone()], t)),
                "sum_over_ranks": _raised(lambda: tstats.sum_over_ranks([t])),
                "ring_hop": _raised(lambda: ring._hop([t], dist.group.WORLD, 0, 0))}


def _serve(s, mesh):
    """The request served after ``shard(mesh)``: (its answer, rounds, what
    the sampler's rule said and the programs it holds; the service)."""
    from aid_tpu_torch.serving import InpaintingService
    svc = InpaintingService.from_config(s["overrides"], device="cpu", max_batch=s["max_batch"])
    svc.shard(mesh)
    rounds = []
    run = svc._run_batch

    def counted(xb, mb, seed):
        rounds.append(xb.shape[0])
        return run(xb, mb, seed)

    svc._run_batch = counted
    got = {"out": svc.inpaint(s["audio"], s["mask"], s["fs"], seed=s["seed"]),
           "rounds": rounds, "max_batch": svc.max_batch,
           "programs_enabled": svc.sampler.programs_enabled(),
           "program_rows": [p.shape[0] for p in svc.sampler._programs.values()]}
    del svc._run_batch
    return got, svc


def job_serve_dp_tp(inp, rank, world, workdir):
    """A request served on a dp=2 x tp=2 mesh; what ``shard`` refuses: a
    tp x cp mesh, and autotune_max_batch afterwards."""
    from aid_tpu_torch.parallel import mesh as pmesh
    from aid_tpu_torch.parallel import ring_attention as ring
    from aid_tpu_torch.parallel import tp
    from aid_tpu_torch.serving import InpaintingService
    served, tp_svc = _serve(inp["serve"], tp.make_tp_mesh(2, n_dp=world // 2,
                                                          device_type="cpu"))
    refused = {}
    svc = InpaintingService.from_config(inp["serve"]["overrides"], device="cpu")
    tp_cp = ("tp", ring.CP_AXIS)
    for name, call in (("tp_cp_mesh", lambda: svc.shard(pmesh.make_grid(2, world // 2, tp_cp,
                                                                         "cpu"))),
                       ("autotune", lambda: tp_svc.autotune_max_batch(limit_bytes=2 ** 30))):
        try:
            call()
        except (ValueError, RuntimeError) as e:
            refused[name] = type(e).__name__
    # over a dp mesh each rank measures its own footprint (here a stand-in
    # that grows by (rank + 1) x 100 MiB a row) and the ranks agree on the
    # tightest rank's rows
    svc.shard()
    svc._footprint = lambda n: (10 + 100 * n * (rank + 1)) * 2 ** 20
    autotuned = {"rows": svc.autotune_max_batch(limit_bytes=2 ** 30),
                 "max_batch": svc.max_batch}
    return {"served": served, "refused": refused, "autotuned": autotuned}


# ------------------------------------------- full-score context parallelism


def _through_cp(fn, x, w, cp):
    """fn on this rank's time block of x (sharded by ``cp.shard``), its
    output gathered, and the gradient of sum(w * output) w.r.t. the whole
    x."""
    xs = torch.from_numpy(x).requires_grad_(True)
    y = cp.gather(fn(cp.shard(xs)))
    (g,) = torch.autograd.grad((y * torch.from_numpy(w)).sum(), xs)
    return {"y": y.detach().numpy(), "dx": g.numpy()}


def _unsharded(fn, x, w):
    xs = torch.from_numpy(x).requires_grad_(True)
    y = fn(xs)
    (g,) = torch.autograd.grad((y * torch.from_numpy(w)).sum(), xs)
    return {"y": y.detach().numpy(), "dx": g.numpy()}


def _cp_pieces(inp, cp):
    """The halo conv, the sharded resampler (down and up), the group std
    and the local-mode ring, each with its unsharded version."""
    from aid_tpu_torch.models import unet_cqt as tunet
    from aid_tpu_torch.ops import fused_adaln
    from aid_tpu_torch.parallel import ring_attention as ring
    out = {}
    conv = tunet.Conv2dFT(6, 5, (5, 3), dilation=(inp["dilation"], 1))
    conv.weight.data = torch.from_numpy(inp["conv_w"])
    conv.requires_grad_(False)
    x, w = inp["x"], inp["w_x"]
    out["conv"] = (_through_cp(lambda a: conv(a, cp), x, inp["w_conv"], cp),
                   _unsharded(conv, x, inp["w_conv"]))
    for up in (False, True):
        wr = inp["w_up" if up else "w_down"]
        out[f"resample_up{up}"] = (
            _through_cp(lambda a: tunet.resample_time(a, up, cp=cp), x, wr, cp),
            _unsharded(lambda a: tunet.resample_time(a, up), x, wr))
    # the group norm as the model uses it: each rank normalises its own
    # rows, so the gradient reaching the moments is that rank's partial one
    def norm(a, cp=None):
        B, F_, T, C = a.shape
        std = fused_adaln.group_std(a, 2, cp)
        return (a.reshape(B, F_, T, 2, C // 2) / std[:, None, None, :, None]).reshape(a.shape)
    out["group_std"] = (_through_cp(lambda a: norm(a, cp), x, w, cp),
                        _unsharded(norm, x, w))
    r = inp["ring"]
    q, k, v, bias = (torch.from_numpy(r[n]).requires_grad_(True) for n in ("q", "k", "v", "bias"))
    Tl = q.shape[2] // cp.n
    rows = bias[:, :, cp.rank * Tl:(cp.rank + 1) * Tl]
    ql, kl, vl = (cp.shard(t) for t in (q, k, v))      # [B, H, T, D]: T is dim 2
    y = cp.gather(cp.ring_attention(ql, kl, vl, rows, 0.25))
    torch.sin(y).sum().backward()
    out["ring"] = {"y": y.detach().numpy(), "dq": q.grad.numpy(), "dk": k.grad.numpy(),
                   "dv": v.grad.numpy(), "dbias": bias.grad.numpy(),
                   "dense": ring._dense(q.detach(), k.detach(), v.detach(), bias.detach(),
                                        0.25).numpy()}
    return out


def _cp_service(s, network_overrides=()):
    from aid_tpu_torch import setup as tsetup
    from aid_tpu_torch.serving import InpaintingService
    from aid_tpu_torch.utils.config import compose
    args = compose(overrides=list(s["overrides"]) + list(network_overrides))
    net = tsetup.setup_network(args, device="cpu", state_dict=s["state_dict"])
    return InpaintingService(args=args, network=net, max_batch=s["max_batch"],
                             sampler=tsetup.setup_sampler(args, net,
                                                          tsetup.setup_diff_parameters(args)))


def job_cp(inp, rank, world, workdir):
    """Full-score context parallelism over every rank as one cp group: the
    pieces, then the tiny U-Net's forward and input gradient with every
    level split (the exchanges counted); on 4 ranks a request served over
    dp=2 x cp=2 with the injected noise, and the tp x cp refusal."""
    from aid_tpu_torch import setup as tsetup
    from aid_tpu_torch.parallel import cp as cpmod
    from aid_tpu_torch.parallel import mesh as pmesh
    from aid_tpu_torch.parallel import ring_attention as ring
    from aid_tpu_torch.sampling import sampler as smod
    from aid_tpu_torch.utils.config import compose
    cp = cpmod.ContextParallel(dist.group.WORLD)
    out = {"pieces": _cp_pieces(inp["pieces"], cp)}

    f = inp["score"]

    def score(extra=(), mesh=True):
        net = tsetup.setup_network(compose(overrides=list(f["overrides"]) + list(extra)),
                                   device="cpu", state_dict=f["state_dict"])
        ring.set_cp_mesh(ring.make_cp_mesh(world, device_type="cpu") if mesh else None)
        try:
            cpmod.reset_counts()
            x = torch.from_numpy(f["audio"]).requires_grad_(True)
            y = net(x, torch.from_numpy(f["cnoise"]))
            (g,) = torch.autograd.grad((y * y).sum(), x)
            return {"y": y.detach().numpy(), "dx": g.numpy(), "counts": cpmod.counts()}
        finally:
            ring.set_cp_mesh(None)

    out["score"] = score()
    out["score_int8"] = (score(["network.quant=int8"]), score(["network.quant=int8"], False))

    if world == 4:
        s = inp["serve"]
        svc = _cp_service(s)
        svc.shard(ring.make_cp_mesh(2, n_dp=2, device_type="cpu"))
        prior, churn = torch.from_numpy(s["prior"]), torch.from_numpy(s["churn"])
        smod.draw_noise = lambda shape, T, generator=None, device=None: (prior, churn)
        flags = [m.context_parallel for m in svc.network.modules()
                 if hasattr(m, "context_parallel")]
        cpmod.reset_counts()
        out["serve_dp_cp"] = {"out": svc.inpaint(s["audio"], s["mask"], s["fs"], seed=3),
                              "flags": flags, "counts": cpmod.counts(),
                              "max_batch": svc.max_batch,
                              "args_flag": svc.args.network["context_parallel"]}
        ring.set_cp_mesh(None)
        try:
            _cp_service(s).shard(pmesh.make_grid(2, 2, ("tp", ring.CP_AXIS), "cpu"))
            out["tp_cp"] = "served"
        except ValueError as e:
            out["tp_cp"] = str(e)
    return out


JOBS = {"train": job_train, "attention": job_attention, "serve_dp_tp": job_serve_dp_tp,
        "cp": job_cp}


def main():
    job, rank, world, workdir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world))
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(workdir, 'rdv')}",
                            rank=rank, world_size=world, timeout=timedelta(seconds=240))
    try:
        inp = torch.load(os.path.join(workdir, "in.pt"), weights_only=False)
        out = JOBS[job](inp, rank, world, workdir)
        torch.save(out, os.path.join(workdir, f"out{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
