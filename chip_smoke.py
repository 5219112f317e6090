#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed):
  1. device: a CUDA device is required; prints the card's name and power
     limit as nvidia-smi reports them;
  2. kernel vs plain: the Triton norm x adaLN x GELU kernel against its plain
     torch version at the flagship's largest launch shapes, at batch 1 and at
     the serving batch, for every GELU variant in f32 and bf16, forward and
     the autograd.Function's gradients;
  3. denoiser: the full-width 22 kHz flagship (random weights from a seed)
     at the serving batch through edm.denoiser and through one guided score
     (forward + backward), with the kernel and with the plain version
     patched in, in f32 and bf16; 90 kernel launches per denoiser forward;
  4. kernel timing: at every launch shape of one denoiser call the kernel is
     held against the plain version at batch 1 and at the serving batch,
     then both are timed at batch 1 (CUDA graphs of back-to-back launches
     over rotating buffers, so no launch finds its data in L2) and summed
     beside the bound;
  5. serving (the main path): InpaintingService.from_config([]) (bf16, T=35,
     order 2, guided) answers 3 requests: an 8.35 s clip with a 1500 ms
     centre gap, ~2.5 windows with four 25 ms gaps, and a clip whose gap
     exceeds 0.6 windows (chained); launch counts and the real-time factor;
  6. the ``kernels`` JSON line, then the device JSON line.

f32 checks run with TF32 off (torch.backends.cuda.matmul.allow_tf32 and
torch.backends.cudnn.allow_tf32 both False).
"""
import contextlib
import json
import math
import os
import sys
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12        # H100 SXM data sheet, f32 outside the tensor cores
# f32 operations per element of the kernel, counted from its body
KERNEL_OPS = {"erf": 16, "tanh": 11, "sigmoid": 6}
# the largest launch shapes (R, C) of a flagship denoiser call
LARGEST = [(131072, 64), (131072, 96), (14336, 256)]


def log(*a):
    print(*a, flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def graph_ms(torch, fn, arg_sets, reps=20):
    """Device time of one call of ``fn``: at least ``reps`` calls cycling
    through ``arg_sets``, every output kept (so each call writes fresh
    memory), captured in a CUDA graph (no host launch cost between calls),
    replayed and timed with CUDA events. The caller makes ``arg_sets`` large
    enough that no call finds its input in L2."""
    k = len(arg_sets)
    n = k * math.ceil(reps / k)
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for a in arg_sets[:3]:
            fn(*a)
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    outs = []
    with torch.cuda.graph(g):
        for i in range(n):
            outs.append(fn(*arg_sets[i % k]))
    g.replay()
    torch.cuda.synchronize()
    best = math.inf
    for _ in range(3):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        torch.cuda.synchronize()
        best = min(best, a.elapsed_time(b) / n)
    del g, outs
    return best


def bf16_ulp_ok(y, ref):
    """|y - ref| within one bf16 ulp of ref (2^-7 of |ref|, plus the
    subnormal floor)."""
    return bool(((y.float() - ref.float()).abs()
                 <= ref.float().abs() * 2.0 ** -7 + 1e-6).all())


@contextlib.contextmanager
def plain_forced(fa):
    """Every norm x adaLN x GELU through the plain torch version: the model
    looks ``fa.norm_adaln_gelu`` up at call time."""
    kernel = fa.norm_adaln_gelu
    fa.norm_adaln_gelu = fa.norm_adaln_gelu_plain
    try:
        yield
    finally:
        fa.norm_adaln_gelu = kernel


def phase_kernel(torch, fa, batches):
    log(f"== phase 2: kernel vs plain at the largest flagship shapes, batch {batches}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {}
    for dt in (torch.float32, torch.bfloat16):
        for gelu in fa.GELU_VARIANTS:
            for B in batches:
                for R, C in LARGEST:
                    x = torch.randn((B, R // 64, 64, C), generator=gen, device="cuda").to(dt)
                    gamma = torch.rand(C, generator=gen, device="cuda") + 0.5
                    aff = torch.randn(B, C, generator=gen, device="cuda") * 0.3
                    w = torch.randn(x.shape, generator=gen, device="cuda")
                    res = {}
                    for name, fn in (("kernel", fa.norm_adaln_gelu),
                                     ("plain", fa.norm_adaln_gelu_plain)):
                        xs = x.clone().requires_grad_(True)
                        gs = gamma.clone().requires_grad_(True)
                        af = aff.clone().requires_grad_(True)
                        y = fn(xs, fa.group_std(xs, 8), gs, af, 1e-7, 8, gelu=gelu)
                        grads = torch.autograd.grad((y.float() * w).sum(), (xs, gs, af))
                        res[name] = (y.detach(), grads)
                    y, yp = res["kernel"][0], res["plain"][0]
                    err = (y.float() - yp.float()).abs().max().item()
                    if dt == torch.float32:
                        ok = bool(((y - yp).abs() <= 1e-5 + 1e-5 * yp.abs()).all())
                        gtol = 1e-4
                    else:
                        ok = bf16_ulp_ok(y, yp)
                        gtol = 2.0 ** -7
                    gerr = max(((a.float() - b.float()).abs().max()
                                / (b.float().abs().max() + 1e-30)).item()
                               for a, b in zip(res["kernel"][1], res["plain"][1]))
                    log(json.dumps({"check": "fused_adaln_fwd", "dtype": str(dt)[6:],
                                    "gelu": gelu, "shape": [B, R, C], "max_abs_err": err,
                                    "fwd_ok": ok, "grad_rel_err": gerr,
                                    "grad_tol": gtol}))
                    if not ok or not gerr <= gtol:
                        fail(f"kernel disagrees with plain: {dt} {gelu} {(B, R, C)}")
                    key = (str(dt)[6:], gelu)
                    worst[key] = max(worst.get(key, 0.0), err)
    log("tolerances: f32 forward |d| <= 1e-5 + 1e-5|ref|; bf16 forward one bf16 "
        "ulp of ref; gradients (x, gamma, aff) max|d|/max|ref| <= 1e-4 f32, 2^-7 bf16")
    return worst


def launch_shapes(torch, net, audio, cn):
    """{(R, C): launches} of one denoiser forward, read from the blocks'
    inputs with forward pre-hooks."""
    from aid_tpu_torch.models.unet_cqt import AdaLNResBlock
    shapes = {}

    def hook(m, args):
        x = args[0]
        key = (x.shape[1] * x.shape[2], m.H[0].weight.shape[0])
        shapes[key] = shapes.get(key, 0) + m.num_dils

    hs = [m.register_forward_pre_hook(hook) for m in net.modules()
          if isinstance(m, AdaLNResBlock)]
    with torch.no_grad():
        net(audio, cn)
    for h in hs:
        h.remove()
    return shapes


def time_kernel(torch, fa, shapes, gelu, dt, batches):
    """At every launch shape: the kernel held against the plain version (one
    bf16 ulp) at each batch in ``batches``; then kernel and plain device
    time at batch 1, summed over one denoiser call's launches, beside the
    bound for the same work. Each shape is timed over enough distinct
    inputs that none is still in L2 when it is read again."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    ms = plain_ms = bytes_ = ops = err = 0.0
    for (R, C), n in sorted(shapes.items()):
        for B in batches:
            x = torch.randn((B, R, C), generator=gen, device="cuda").to(dt)
            inv = torch.rand(B, C, generator=gen, device="cuda") + 0.5
            mod = torch.rand(B, C, generator=gen, device="cuda") + 0.5
            with torch.no_grad():
                y, yp = fa._fused_cuda(x, inv, mod, gelu), fa.fused_plain(x, inv, mod, gelu)
            if not bf16_ulp_ok(y, yp):
                fail(f"kernel disagrees with plain at launch shape {(B, R, C)}")
            err = max(err, (y.float() - yp.float()).abs().max().item())
        step = 2 * R * C * x.element_size()              # one read, one write
        sets = [(torch.randn((1, R, C), generator=gen, device="cuda").to(dt),
                 inv[:1].contiguous(), mod[:1].contiguous(), gelu)
                for _ in range(max(2, math.ceil(3 * l2 / step)))]
        with torch.no_grad():
            k = graph_ms(torch, fa._fused_cuda, sets)
            p = graph_ms(torch, fa.fused_plain, sets)
        del sets
        log(json.dumps({"timing": "fused_adaln_fwd launch", "shape": [1, R, C],
                        "launches": n, "ms": k, "plain_ms": p,
                        "bytes_bound_ms": step / HBM_BYTES_PER_S * 1e3}))
        ms += n * k
        plain_ms += n * p
        bytes_ += n * (step + 2 * C * 4)
        ops += n * R * C * KERNEL_OPS[gelu]
    bms, oms = bytes_ / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS_PER_S * 1e3
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=max(bms, oms),
                bound_by="bytes" if bms >= oms else "operations",
                bytes=bytes_, launches=sum(shapes.values()), max_abs_err=err,
                l2_bytes=l2)


def phase_denoiser(torch, fa, batch):
    log(f"== phase 3: flagship denoiser and guided score at batch {batch}, "
        "kernel vs plain")
    from aid_tpu_torch.diffusion import edm
    from aid_tpu_torch.tools.profile_denoiser import flagship_case
    shapes = None
    for cd, tol in (("float32", 1e-5), ("bfloat16", 2e-2)):
        case = flagship_case(cd, batch)
        net, p, audio, sigma = case.net, case.sampler.p, case.audio, case.sigma
        if shapes is None:
            shapes = launch_shapes(torch, net, audio, edm.cnoise(p, sigma[:, None]))
        out = {}
        for fused in (True, False):
            with contextlib.nullcontext() if fused else plain_forced(fa):
                fa.reset_launch_count()
                with torch.no_grad():
                    d = edm.denoiser(p, net, audio, sigma)
                torch.cuda.synchronize()
                n_fwd = fa.launch_count()
                fa.reset_launch_count()
                s = case.score(audio, sigma[0])
                torch.cuda.synchronize()
                out[fused] = (d, s, n_fwd, fa.launch_count())
        (d, s, n_fwd, n_score), (dp, sp, n0, n1) = out[True], out[False]
        d_err = ((d - dp).abs().max() / dp.abs().max()).item()
        s_err = ((s - sp).abs().max() / sp.abs().max()).item()
        rec = {"check": "denoiser", "compute_dtype": cd, "batch": batch,
               "launches_per_forward": n_fwd, "launches_per_guided_score": n_score,
               "plain_launches": n0 + n1, "denoiser_rel_err": d_err,
               "guided_score_rel_err": s_err, "tol": tol,
               "finite": bool(torch.isfinite(d).all() and torch.isfinite(s).all())}
        log(json.dumps(rec))
        if n_fwd != 90 or n_score != 90 or n0 + n1 != 0:
            fail(f"expected 90 kernel launches per denoiser call: {rec}")
        if not (rec["finite"] and d_err <= tol and s_err <= tol):
            fail(f"denoiser kernel vs plain: {rec}")
        del case, net, out, d, s, dp, sp
        torch.cuda.empty_cache()
    log("per-denoiser-call launch shapes {(R, C): launches}: "
        + json.dumps({f"{r}x{c}": n for (r, c), n in sorted(shapes.items())}))
    return shapes


def music(np, n, fs, seed):
    """A synthetic piano-like test signal: decaying harmonic notes + noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / fs
    x = np.zeros(n)
    for onset in np.arange(0.0, n / fs, 0.5):
        f0 = 110.0 * 2 ** (rng.integers(0, 36) / 12)
        env = np.where(t >= onset, np.exp(-(t - onset) * 3.0), 0.0)
        for h in range(1, 6):
            x += env * np.sin(2 * np.pi * f0 * h * t) / h
    x += 0.01 * rng.standard_normal(n)
    return (0.1 * x / np.abs(x).max()).astype(np.float32)


def phase_serving(torch, fa, np, batches):
    log("== phase 5: InpaintingService.from_config([]) answers 3 requests")
    from aid_tpu_torch.models.unet_cqt import MAIN_SCALE
    from aid_tpu_torch.serving import InpaintingService
    t0 = time.time()
    svc = InpaintingService.from_config([])
    svc.network.init_weights(0, gate_scale=MAIN_SCALE)   # trained-like gates
    L, fs = int(svc.args.exp.audio_len), int(svc.args.exp.sample_rate)
    T, order = svc.sampler.cfg.T, svc.sampler.cfg.order
    log(f"service built in {time.time() - t0:.1f} s: L={L} fs={fs} T={T} order={order} "
        f"max_batch={svc.max_batch} dtype={svc.network.dtype}")
    rounds = []
    run = svc._run_batch

    def counted(xb, mb, seed):
        rounds.append(xb.shape[0])
        return run(xb, mb, seed)

    svc._run_batch = counted
    g25, g1500 = int(0.025 * fs), int(1.5 * fs)
    reqs = []
    n = L
    m = np.ones(n, np.float32)
    m[(n - g1500) // 2:(n - g1500) // 2 + g1500] = 0.0
    reqs.append(("a_centre_gap_1500ms", n, m))
    n = int(2.5 * L)
    m = np.ones(n, np.float32)
    for c in (0.2, 0.45, 0.7, 0.9):
        s = int(c * n)
        m[s:s + g25] = 0.0
    reqs.append(("b_four_25ms_gaps", n, m))
    n = 2 * L
    m = np.ones(n, np.float32)
    g = int(0.9 * L)
    m[L // 2:L // 2 + g] = 0.0
    reqs.append(("c_chained_gap", n, m))

    steps_per_traj = 2 * T - 1 if order == 2 else T
    torch.cuda.synchronize()
    fa.reset_launch_count()          # the main path starts here
    results = []
    for name, n, m in reqs:
        audio = music(np, n, fs, seed=len(results))
        r0 = len(rounds)
        t1 = time.time()
        out = svc.inpaint(audio, m, fs, seed=1)
        wall = time.time() - t1
        gap = m < 0.5
        rec = {"request": name, "seconds_of_audio": n / fs, "gap_samples": int(gap.sum()),
               "rounds": rounds[r0:], "wall_s": wall, "rtf": n / fs / wall,
               "finite": bool(np.isfinite(out).all()),
               "observed_exact": bool(np.array_equal(out[~gap], audio[~gap])),
               "gap_nonzero": bool(np.abs(out[gap]).max() > 0),
               "gap_rms": float(np.sqrt(np.mean(out[gap] ** 2)))}
        log(json.dumps(rec))
        results.append(rec)
    launches = fa.launch_count()     # ... and ends here
    expected = 90 * steps_per_traj * len(rounds)
    log(json.dumps({"check": "serving_launches", "launches": launches,
                    "expected": expected, "rounds": len(rounds),
                    "score_calls_per_round": steps_per_traj}))
    for rec in results:
        if not (rec["finite"] and rec["observed_exact"] and rec["gap_nonzero"]):
            fail(f"bad inpainting output: {rec}")
    if launches != expected:
        fail(f"kernel launches {launches} != {expected}: the path skipped the kernel")
    if not set(rounds) <= set(batches):
        fail(f"rounds of {sorted(set(rounds))} rows; the kernel was checked at {batches}")
    return launches, results[0]["rtf"]


def main():
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on an NVIDIA GPU")
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    # Triton's compiled kernels go under the checkout (listed in .gitignore)
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(here, ".triton_cache"))
    from aid_tpu_torch.ops import fused_adaln as fa
    from aid_tpu_torch.tools.profile_denoiser import gpu_line
    from aid_tpu_torch.utils.config import compose

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()
    card = gpu_line()
    log("== phase 1: device")
    log(f"gpu: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    # serving co-batches up to this many windows a round; every check and
    # the denoiser comparison run at it as well as at batch 1
    serve_batch = int(compose().network.get("serving_max_batch", 2))
    batches = sorted({1, serve_batch})

    worst = phase_kernel(torch, fa, batches)
    shapes = phase_denoiser(torch, fa, serve_batch)

    log(f"== phase 4: kernel at every launch shape, checked at batch {batches}; "
        "timed per batch row over one flagship denoiser call (bf16, tanh: the "
        "served configuration)")
    timing = time_kernel(torch, fa, shapes, "tanh", torch.bfloat16, batches)
    log(json.dumps({"timing": "fused_adaln_fwd per denoiser call", **timing,
                    "card": card}))
    log("library_ms: null -- no single PyTorch call computes gelu(x * inv * mod)")

    launches, rtf = phase_serving(torch, fa, np, batches)
    log(json.dumps({"inpaint_rtf_request_a": rtf, "card": card}))

    kernels = [{"name": "fused_adaln_fwd", "route": "triton",
                "source": "aid_tpu_torch/ops/fused_adaln.py",
                "replaces": "aid_tpu/ops/pallas/fused_adaln.py:62",
                "launches": launches,
                "max_abs_err": max(worst[("bfloat16", "tanh")], timing["max_abs_err"]),
                "ms": timing["ms"], "plain_ms": timing["plain_ms"],
                "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
                "library_ms": None}]
    log(f"total {time.time() - t_start:.1f} s")
    log(f"gpu: {card}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
