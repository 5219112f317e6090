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
  3b. the network options, bf16, batch 1: the flagship with
     network.use_fencoding and with network.quant=int8, one denoiser call
     and one guided score each, kernel vs plain; for int8 the prequantized
     kernels against the dynamic path (bit for bit) and the distance from
     the bf16 network on the same weights (gated only on being finite:
     the weights are random);
  4. kernel timing: at every launch shape of one denoiser call the kernel is
     held against the plain version at batch 1 and at the serving batch,
     then both are timed at batch 1 (CUDA graphs of back-to-back launches
     over rotating buffers, so no launch finds its data in L2) and summed
     beside the bound;
  5. serving (the main path): InpaintingService.from_config([]) (bf16, T=35,
     order 2, guided) answers 3 requests: an 8.35 s clip with a 1500 ms
     centre gap, ~2.5 windows with four 25 ms gaps, and a clip whose gap
     exceeds 0.6 windows (chained); launch counts and the real-time factor;
  5b. the 44.1 kHz MusicNet flagship (network=cqtdiff_plus_44k,
     exp=musicnet44k_4s, bf16, batch 1): its denoiser and guided score with
     the kernel and with the plain version (111 launches per call); the
     kernel held against the plain version and timed at every 44 kHz launch
     shape as in phase 4; then InpaintingService.from_config runs
     autotune_max_batch (max_batch must stay 1) and precompile, restores a
     12 s 48 kHz WAV with a 1000 ms and a 3000 ms gap through inpaint_file
     (resampled in and out; the written file at 48 kHz and the input's
     length, observed samples within one 16-bit step of the input file) and
     a 4.18 s 44.1 kHz request with a 1500 ms centre gap (observed samples
     bit-exact); the resampler route and the native library's build status;
  6. training (the second main path) on a synthetic corpus in MAESTRO v3
     layout (CSV + WAVs at 44.1 and 48 kHz, longer than load_len), full
     flagship width, batch 4, f32:
       a. the kernel against its plain version at batch 4, f32, tanh, at the
          largest launch shapes: forward and the autograd.Function's dx,
          dinv and dmod; then at every launch shape, timed at batch 4 f32
          over one training forward as in phase 4;
       b. one training step with the kernel and one with the plain version
          (mixed-rate batch, TF32 off): loss and pre-clip gradient norm;
          the first step leaves the parameters as they were (lr 0);
       c. the gradients with remat "block" and "conv" against no remat,
          with the peak memory of each;
       d. four steps, a checkpoint at step 2, a fresh trainer resumed from
          it takes steps 3 and 4 on the same batches and draws, and ends
          where the uninterrupted trainer ended;
       e. the entry point: aid_tpu_torch.train.main runs 4 steps from the
          corpus (remat on, TF32 as the training default), checkpoints at 2
          and 4; a second main resumes from the step-2 checkpoint and
          reaches step 4; step time, peak memory and launches per step;
  7. multi-device (the port's torch.distributed path), full flagship width:
       a. ``aid_tpu_torch.train.main`` with exp.mesh.fsdp over NCCL, one rank
          (the card count), 2 steps, TF32 as the training default: launches,
          step time, peak memory, the checkpoint in the one-device layout;
       b. two ranks sharing the card over gloo (this script again, with
          ``--rank R DIR``), each holding the kernel against its plain
          version: 2 DDP steps and 2 FSDP steps at global batch 4, f32, TF32
          off, against the one-rank trainer's steps on the same batch and
          draws (loss, pre-clip norm, parameters); step time and peak memory
          per rank;
       c. ``InpaintingService.shard()`` over dp=2 answers phase 5's request
          (b) (2 rows a round, one per rank): within phase 3's bf16
          tolerance of phase 5's answer, observed samples bit-exact, RTF;
       d. one f32 guided score with the conv and dense layers split over
          tp=2, and (e) one with attention_dict.context_parallel over a cp=2
          mesh, each against the replicated score: errors and wall times;
       f. full-score context parallelism (network.context_parallel) over
          cp=2, f32, batch 1: the denoiser output, the input gradient and
          one guided score against the replicated ones; wall time, halo
          exchanges and ring layers per score, the levels sharded;
       g. ``shard`` over a (dp=1, cp=2) mesh answers phase 5's request (a)
          at tester.T=4, Schurn=0 (bf16): within phase 3's bf16 tolerance
          of the one-rank service at the same settings, observed samples
          bit-exact, RTF;
       every rank's launches go into the kernels line;
  8. evaluation (the third main path) at full flagship width, bf16, on the
     same corpus with a test-split row at 44.1 kHz (resampled to 22.05 kHz
     by the tester):
       a. ``aid_tpu_torch.test.main`` runs the inpainting mode at T=35 on one
          file with phase 6e's checkpoint, found by the latest-checkpoint
          scan: seconds and real-time factor;
       b. a second main runs the other nine modes at T=4 (one unconditional
          sample, two autoregressive segments, random short gaps, the four
          MUSHRA gaps): seconds per mode;
       c. the in-training demo: ``aid_tpu_torch.train.main`` for one step
          with ``heavy_log_interval`` 1 writes heavy_logging/it_1/uncond_0.wav;
          every wav of a-c finite, every metrics.json with finite LSD and
          SNR, the inpainting output equal to the original (within one 16-bit
          step) farther than ``hann_size`` from the gap, and the kernel's
          launches over a-c equal to 90 per denoiser call plus 180 per
          training step;
       d. a reference-layout ``.pt`` written from a seeded network loads back
          exactly, and ``test_inpainting`` with the plain version patched in
          agrees with the kernel run within phase 3's bf16 tolerance;
  10. the port learns, and the user tools (after phase 8, in its work
     directory), bf16 serving at full flagship width unless said:
       a. the learning gate: ``scripts/e2e_smoke_torch.run`` trains the tiny
          CQTDiff+ on synthetic chords (SMOKE_L 16384, 400 steps at batch 8,
          f32 with TF32 convs) and inpaints a 50 ms gap with its EMA before
          and after (T=25, order 2, xi=0.25, bf16); it must lift the gap SNR
          by >= 4.0 dB and cut the gap LSD to <= 0.95 of the untrained
          net's (the JAX package's pinned gates); the trained EMA sampled
          with the plain version within phase 3's bf16 tolerance; the
          kernel against the plain version at every tiny-net launch shape
          (f32 at batch 8, bf16 at batch 1); launches per step and run;
       b. ``scripts/make_synth_corpus_torch.py`` writes two 19 s test files;
       c. ``scripts/eval_checkpoints_torch.py`` on phase 6e's model
          directory (its step-2 and step-4 checkpoints), 2 clips:
          eval_ledger.json, every SNR, LSD and FAD finite, the two
          checkpoints' EMA weights different;
       d. ``scripts/eval_gap_sweep_torch.py`` on the step-4 checkpoint:
          four gap lengths, finite numbers;
       e. ``examples/demo_inpainting_torch.py`` in its own process, with the
          step-4 checkpoint and a 1500 ms gap (the written files' observed
          samples bit-exact), then with ``--spectrogram``;
       f. ``scripts/serve_bench_torch.py`` with SERVE_REPS 1: its three
          rows with the card;
       g. ``export_checkpoint_from`` on the step-4 checkpoint: the reference
          ``.pt`` loads back bit-equal; ``parity_vs_reference_torch``
          exports its f32 denoiser (finite) and passes against itself;
     10c-10g run tester.T=8 (cut from 35 for the time budget);
  9. the ``kernels`` JSON line (phase 10's launches and errors included),
     then the device JSON line.

f32 comparisons run with TF32 off (torch.backends.cuda.matmul.allow_tf32
and torch.backends.cudnn.allow_tf32 both False).
"""
import contextlib
import gc
import json
import math
import os
import shutil
import sys
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12        # H100 SXM data sheet, f32 outside the tensor cores
# f32 operations per element of the kernel, counted from its body
KERNEL_OPS = {"erf": 16, "tanh": 11, "sigmoid": 6}
# the largest launch shapes (R, C) of a flagship denoiser call
LARGEST = [(131072, 64), (131072, 96), (14336, 256)]
LSB = 1.0 / 32767          # one step of a 16-bit wav
BF16_TOL = 2e-2            # phase 3's bf16 tolerance, max|d| / max|ref|
# the 44.1 kHz MusicNet flagship (phase 5b)
NET44 = ["network=cqtdiff_plus_44k", "exp=musicnet44k_4s"]
LAUNCHES_44K = 111         # fused-kernel launches per 44 kHz denoiser call
FLAGSHIP_LAUNCHES = 90     # ... per 22 kHz denoiser call


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


def check_launch_shapes(torch, fa, shapes, gelu, dt, batches, gen):
    """The kernel against the plain version at every launch shape (R, C) of
    ``shapes`` and batch of ``batches``, within one bf16 ulp of the plain
    result (in f32 as in bf16, as phase 4 holds them). Returns the largest
    absolute error."""
    err = 0.0
    for (R, C) in sorted(shapes):
        for B in batches:
            x = torch.randn((B, R, C), generator=gen, device="cuda").to(dt)
            inv = torch.rand(B, C, generator=gen, device="cuda") + 0.5
            mod = torch.rand(B, C, generator=gen, device="cuda") + 0.5
            with torch.no_grad():
                y, yp = fa._fused_cuda(x, inv, mod, gelu), fa.fused_plain(x, inv, mod, gelu)
            if not bf16_ulp_ok(y, yp):
                fail(f"kernel disagrees with plain at launch shape {(B, R, C)}, {dt}")
            err = max(err, (y.float() - yp.float()).abs().max().item())
    return err


def time_kernel(torch, fa, shapes, gelu, dt, batches, time_batch=1):
    """At every launch shape: the kernel held against the plain version (one
    bf16 ulp) at each batch in ``batches``; then kernel and plain device
    time at batch ``time_batch`` (at most the last of ``batches``), summed
    over one denoiser call's launches, beside the bound for the same work.
    Each shape is timed over enough distinct inputs that none is still in L2
    when it is read again."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    err = check_launch_shapes(torch, fa, shapes, gelu, dt, batches, gen)
    ms = plain_ms = bytes_ = ops = 0.0
    for (R, C), n in sorted(shapes.items()):
        Bt = time_batch
        inv = torch.rand(Bt, C, generator=gen, device="cuda") + 0.5
        mod = torch.rand(Bt, C, generator=gen, device="cuda") + 0.5
        step = 2 * Bt * R * C * torch.finfo(dt).bits // 8   # one read, one write
        sets = [(torch.randn((Bt, R, C), generator=gen, device="cuda").to(dt), inv, mod, gelu)
                for _ in range(max(2, math.ceil(3 * l2 / step)))]
        with torch.no_grad():
            k = graph_ms(torch, fa._fused_cuda, sets)
            p = graph_ms(torch, fa.fused_plain, sets)
        del sets
        log(json.dumps({"timing": "fused_adaln_fwd launch", "shape": [Bt, R, C],
                        "launches": n, "ms": k, "plain_ms": p,
                        "bytes_bound_ms": step / HBM_BYTES_PER_S * 1e3}))
        ms += n * k
        plain_ms += n * p
        bytes_ += n * (step + 2 * Bt * C * 4)
        ops += n * Bt * R * C * KERNEL_OPS[gelu]
    bms, oms = bytes_ / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS_PER_S * 1e3
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=max(bms, oms),
                bound_by="bytes" if bms >= oms else "operations",
                bytes=bytes_, launches=sum(shapes.values()), max_abs_err=err,
                l2_bytes=l2)


def compare_denoiser(torch, fa, case, tol, expected, **tags):
    """One denoiser call and one guided score of ``case`` with the kernel
    and with the plain version patched in: relative errors within ``tol``,
    ``expected`` launches per call with the kernel and none without."""
    from aid_tpu_torch.diffusion import edm
    net, p, audio, sigma = case.net, case.sampler.p, case.audio, case.sigma
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
    rec = {"check": "denoiser", **tags, "batch": audio.shape[0],
           "launches_per_forward": n_fwd, "launches_per_guided_score": n_score,
           "plain_launches": n0 + n1, "denoiser_rel_err": d_err,
           "guided_score_rel_err": s_err, "tol": tol,
           "finite": bool(torch.isfinite(d).all() and torch.isfinite(s).all())}
    log(json.dumps(rec))
    if n_fwd != expected or n_score != expected or n0 + n1 != 0:
        fail(f"expected {expected} kernel launches per denoiser call: {rec}")
    if not (rec["finite"] and d_err <= tol and s_err <= tol):
        fail(f"denoiser kernel vs plain: {rec}")
    return rec


def case_shapes(torch, case):
    from aid_tpu_torch.diffusion import edm
    return launch_shapes(torch, case.net, case.audio,
                         edm.cnoise(case.sampler.p, case.sigma[:, None]))


def phase_denoiser(torch, fa, batch):
    log(f"== phase 3: flagship denoiser and guided score at batch {batch}, "
        "kernel vs plain")
    from aid_tpu_torch.tools.profile_denoiser import flagship_case
    shapes = None
    for cd, tol in (("float32", 1e-5), ("bfloat16", BF16_TOL)):
        case = flagship_case(cd, batch)
        if shapes is None:
            shapes = case_shapes(torch, case)
        compare_denoiser(torch, fa, case, tol, 90, compute_dtype=cd)
        del case
        gc.collect()
        torch.cuda.empty_cache()
    log("per-denoiser-call launch shapes {(R, C): launches}: "
        + json.dumps({f"{r}x{c}": n for (r, c), n in sorted(shapes.items())}))
    return shapes


def phase_options(torch, fa, card):
    """3b: the flagship with use_fencoding and with int8 quantization (bf16,
    batch 1), kernel vs plain; int8 prequantized vs dynamic, and against
    the bf16 network on the same weights."""
    from aid_tpu_torch.diffusion import edm
    from aid_tpu_torch.ops import qconv
    from aid_tpu_torch.tools.profile_denoiser import flagship_case
    log("== phase 3b: network options at full 22 kHz width, bf16, batch 1: "
        "use_fencoding, quant=int8")
    t0 = time.time()
    case = flagship_case("bfloat16", 1, overrides=["network.use_fencoding=True"])
    fenc = compare_denoiser(torch, fa, case, BF16_TOL, 90, option="use_fencoding",
                            compute_dtype="bfloat16")
    del case
    case = flagship_case("bfloat16", 1, overrides=["network.quant=int8"])
    int8 = compare_denoiser(torch, fa, case, BF16_TOL, 90, option="quant=int8",
                            compute_dtype="bfloat16")
    net, p, audio, sigma = case.net, case.sampler.p, case.audio, case.sigma

    def run():
        torch.cuda.synchronize()
        t1 = time.time()
        with torch.no_grad():
            d = edm.denoiser(p, net, audio, sigma)
        s = case.score(audio, sigma[0])
        torch.cuda.synchronize()
        return d, s, time.time() - t1

    n_pre = qconv.prequantize_params(net, torch.bfloat16)
    d_pre, s_pre, _ = run()
    d_pre, s_pre, wall_int8 = run()
    eligible = qconv.prequant_eligible
    qconv.prequant_eligible = lambda w: False
    try:
        d_dyn, s_dyn, _ = run()
    finally:
        qconv.prequant_eligible = eligible
    del case
    gc.collect()
    ref = flagship_case("bfloat16", 1)                  # the same seeded weights, bf16
    with torch.no_grad():
        d_bf = edm.denoiser(ref.sampler.p, ref.net, ref.audio, ref.sigma)
    ref.score(ref.audio, ref.sigma[0])
    torch.cuda.synchronize()
    t1 = time.time()
    with torch.no_grad():
        d_bf = edm.denoiser(ref.sampler.p, ref.net, ref.audio, ref.sigma)
    s_bf = ref.score(ref.audio, ref.sigma[0])
    torch.cuda.synchronize()
    wall_bf16 = time.time() - t1
    rec = {"check": "int8", "prequantized_kernels": n_pre,
           "prequantized_equals_dynamic": bool(torch.equal(d_pre, d_dyn)
                                               and torch.equal(s_pre, s_dyn)),
           "denoiser_rel_err_vs_bf16": rel(d_pre, d_bf),
           "guided_score_rel_err_vs_bf16": rel(s_pre, s_bf),
           "finite": bool(torch.isfinite(d_pre).all() and torch.isfinite(s_pre).all()),
           "denoiser_plus_score_s": {"int8": wall_int8, "bf16": wall_bf16},
           "phase_s": time.time() - t0, "card": card}
    log(json.dumps(rec))
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    if not (rec["prequantized_equals_dynamic"] and rec["finite"] and n_pre > 0
            and math.isfinite(rec["denoiser_rel_err_vs_bf16"])):
        fail(f"int8 network: {rec}")
    return {"fencoding": fenc, "int8": int8, "int8_vs_bf16": rec}


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
    results, answers = [], {}
    for name, n, m in reqs:
        audio = music(np, n, fs, seed=len(results))
        r0 = len(rounds)
        t1 = time.time()
        out = svc.inpaint(audio, m, fs, seed=1)
        answers[name] = {"audio": audio, "mask": m, "fs": fs, "answer": out}
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
    return launches, results[0]["rtf"], answers


def phase_serving_44k(torch, fa, np, work, card):
    """5b: the 44.1 kHz MusicNet flagship: kernel and denoiser checks at its
    launch shapes, then InpaintingService over files at 48 kHz and a
    request at 44.1 kHz."""
    from aid_tpu_torch.data import audio_io
    from aid_tpu_torch.models.unet_cqt import MAIN_SCALE
    from aid_tpu_torch.serving import InpaintingService
    from aid_tpu_torch.tools.profile_denoiser import flagship_case
    log("== phase 5b: the 44.1 kHz MusicNet flagship (network=cqtdiff_plus_44k, "
        "exp=musicnet44k_4s), bf16, batch 1")
    log(json.dumps({"native_audio_library": audio_io.native_status(),
                    "resampler_route": audio_io.resampler_route()}))
    case = flagship_case("bfloat16", 1, overrides=NET44)
    shapes = case_shapes(torch, case)
    log("44 kHz per-denoiser-call launch shapes {(R, C): launches}: "
        + json.dumps({f"{r}x{c}": n for (r, c), n in sorted(shapes.items())}))
    log("== phase 5b(b): 44 kHz denoiser and guided score, kernel vs plain")
    compare_denoiser(torch, fa, case, BF16_TOL, LAUNCHES_44K, model="44k",
                     compute_dtype="bfloat16")
    del case
    gc.collect()
    torch.cuda.empty_cache()
    log("== phase 5b(a): kernel vs plain at every 44 kHz launch shape, batch 1, bf16, tanh; "
        "timed per denoiser call")
    timing = time_kernel(torch, fa, shapes, "tanh", torch.bfloat16, [1])
    log(json.dumps({"timing": "fused_adaln_fwd per 44 kHz denoiser call", **timing,
                    "card": card}))

    log("== phase 5b(c): InpaintingService.from_config(network=cqtdiff_plus_44k, "
        "exp=musicnet44k_4s): autotune_max_batch, precompile, inpaint_file at 48 kHz, "
        "a 44.1 kHz request")
    t0 = time.time()
    svc = InpaintingService.from_config(NET44)
    svc.network.init_weights(0, gate_scale=MAIN_SCALE)   # trained-like gates
    L, fs = int(svc.args.exp.audio_len), int(svc.args.exp.sample_rate)
    steps = 2 * svc.sampler.cfg.T - 1 if svc.sampler.cfg.order == 2 else svc.sampler.cfg.T
    log(f"service built in {time.time() - t0:.1f} s: L={L} fs={fs} T={svc.sampler.cfg.T} "
        f"order={svc.sampler.cfg.order} max_batch={svc.max_batch} dtype={svc.network.dtype}")
    configured = svc.max_batch
    feet, foot = {}, svc._footprint
    svc._footprint = lambda n: feet.setdefault(n, foot(n))
    t0 = time.time()
    fit = svc.autotune_max_batch()
    per_row = max(feet[2] - feet[1], 1)
    rec = {"check": "autotune_max_batch", "fit": fit, "max_batch": svc.max_batch,
           "configured_max_batch": configured, "footprint_bytes": feet,
           "per_row_bytes": per_row, "fixed_bytes": max(feet[1] - per_row, 0),
           "limit_bytes": torch.cuda.get_device_properties(0).total_memory,
           "wall_s": time.time() - t0, "card": card}
    log(json.dumps(rec))
    if not (fit >= 1 and svc.max_batch == configured == 1):
        fail(f"autotune_max_batch: {rec}")
    t0 = time.time()
    svc.precompile()
    log(json.dumps({"check": "precompile", "wall_s": time.time() - t0,
                    "max_batch": svc.max_batch, "card": card}))

    rounds, run = [], svc._run_batch

    def counted(xb, mb, seed):
        rounds.append(xb.shape[0])
        return run(xb, mb, seed)

    svc._run_batch = counted
    results, inpaint = {}, svc.inpaint

    def kept(audio, mask, rate, seed=0):
        results["out"] = inpaint(audio, mask, rate, seed=seed)
        return results["out"]

    svc.inpaint = kept
    hann = svc.sampler.hann_size
    fs48, n48 = 48000, 12 * 48000
    src, dst = os.path.join(work, "music_48k.wav"), os.path.join(work, "music_48k_restored.wav")
    audio_io.write(src, music(np, n48, fs48, seed=44), fs48)
    m48 = np.ones(n48, np.float32)
    gaps48 = [(int(2.0 * fs48), int(3.0 * fs48)), (int(6.0 * fs48), int(9.0 * fs48))]
    for a, b in gaps48:
        m48[a:b] = 0.0
    n44 = L
    m44 = np.ones(n44, np.float32)
    g = int(1.5 * fs)
    m44[(n44 - g) // 2:(n44 - g) // 2 + g] = 0.0
    a44 = music(np, n44, fs, seed=45)

    torch.cuda.synchronize()
    fa.reset_launch_count()          # the 44 kHz serving path starts here
    t0 = time.time()
    svc.inpaint_file(src, m48, dst, seed=1)
    wall_file = time.time() - t0
    rounds_file = list(rounds)
    out_file = results["out"]
    t0 = time.time()
    out44 = svc.inpaint(a44, m44, fs, seed=2)
    wall44 = time.time() - t0
    launches = fa.launch_count()     # ... and ends here

    x_in, rate_in = audio_io.read(src)
    x_out, rate_out = audio_io.read(dst)
    far = np.ones(n48, bool)
    for a, b in gaps48:
        far[max(a - hann, 0):b + hann] = False
    gap48, gap44 = m48 < 0.5, m44 < 0.5
    rec_file = {"request": "file_48k_12s_gaps_1000ms_3000ms", "seconds_of_audio": n48 / fs48,
                "written_rate": rate_out, "written_len": len(x_out), "rounds": rounds_file,
                "wall_s": wall_file, "rtf": n48 / fs48 / wall_file,
                "finite": bool(np.isfinite(out_file).all()),
                "observed_exact_in_memory": bool(np.array_equal(out_file[~gap48], x_in[~gap48])),
                "far_max_abs_err_in_file": float(np.abs(x_out[far] - x_in[far]).max()),
                "far_tol": LSB, "gap_nonzero": bool(all(
                    np.abs(out_file[a:b]).max() > 0 for a, b in gaps48)),
                "gap_rms": float(np.sqrt(np.mean(out_file[gap48] ** 2)))}
    rec44 = {"request": "a44_centre_gap_1500ms", "seconds_of_audio": n44 / fs,
             "rounds": rounds[len(rounds_file):], "wall_s": wall44, "rtf": n44 / fs / wall44,
             "finite": bool(np.isfinite(out44).all()),
             "observed_exact": bool(np.array_equal(out44[~gap44], a44[~gap44])),
             "gap_nonzero": bool(np.abs(out44[gap44]).max() > 0),
             "gap_rms": float(np.sqrt(np.mean(out44[gap44] ** 2)))}
    expected = LAUNCHES_44K * steps * len(rounds)
    for r in (rec_file, rec44):
        log(json.dumps({**r, "card": card}))
    log(json.dumps({"check": "serving_44k_launches", "launches": launches, "expected": expected,
                    "rounds": len(rounds), "score_calls_per_round": steps}))
    ok = (rate_in == rate_out == fs48 and len(x_out) == len(x_in) == n48
          and rec_file["finite"] and rec_file["observed_exact_in_memory"]
          and rec_file["far_max_abs_err_in_file"] <= LSB and rec_file["gap_nonzero"]
          and rec44["finite"] and rec44["observed_exact"] and rec44["gap_nonzero"]
          and set(rounds) == {1} and launches == expected)
    if not ok:
        fail(f"44 kHz serving: {rec_file} {rec44} launches {launches} != {expected}?")
    del svc
    gc.collect()
    torch.cuda.empty_cache()
    return launches, timing, {"rtf_file_48k": rec_file["rtf"], "rtf_44k_request": rec44["rtf"],
                              "autotune_fit": fit}


# ---------------------------------------------------------------- training

TRAIN_BATCH = 4
CORPUS_RATES = (44100, 48000, 44100, 48000)   # CSV order; one file each


def write_corpus(np, root, load_len, test_len):
    """MAESTRO v3 layout: maestro-v3.0.0.csv (split, year, audio_filename),
    16-bit WAVs of music() a little longer than load_len for training, and
    one test-split file of 2009 at 44.1 kHz, a little longer than test_len."""
    from aid_tpu_torch.data import audio_io
    for year in ("2015", "2009"):
        os.makedirs(os.path.join(root, year), exist_ok=True)
    rows = ["split,year,audio_filename"]
    for j, fs in enumerate(CORPUS_RATES):
        rel = f"2015/piece_{j}.wav"
        audio_io.write(os.path.join(root, rel), music(np, load_len + 15000 + 1000 * j, fs, 20 + j),
                       fs)
        rows.append(f"train,2015,{rel}")
    audio_io.write(os.path.join(root, "2009/test_piece.wav"), music(np, test_len + 4410, 44100, 30),
                   44100)
    rows.append("test,2009,2009/test_piece.wav")
    with open(os.path.join(root, "maestro-v3.0.0.csv"), "w") as f:
        f.write("\n".join(rows) + "\n")


def train_overrides(corpus, model_dir, *extra):
    return [f"dset.path={corpus}", "dset.years=[2015]", "dset.segments_per_file=1",
            f"model_dir={model_dir}", "logging.print_model_summary=False", *extra]


def mixed_batches(np, args, n):
    """n host batches of [44.1k, 48k, 44.1k, 48k] segments drawn from the
    corpus by MaestroDatasetFs."""
    from aid_tpu_torch.data.maestro import MaestroDatasetFs
    it = iter(MaestroDatasetFs(args))
    pools = {44100: [], 48000: []}
    out = []
    while len(out) < n:
        x, fs = next(it)
        pools[fs].append(x)
        if len(pools[44100]) >= 2 and len(pools[48000]) >= 2:
            rows = [pools[44100].pop(), pools[48000].pop(), pools[44100].pop(),
                    pools[48000].pop()]
            out.append((np.stack(rows), np.array([44100, 48000, 44100, 48000])))
    return out


def numpy_draws(np, p, rng, B, L):
    """One micro-batch of draws: polarity signs, sigmas from the training
    distribution, sigma-scaled noise (as the trainer would draw them)."""
    a = rng.random(B)
    lo, hi = p.sigma_min ** (1 / p.rho_train), p.sigma_max ** (1 / p.rho_train)
    sigma = ((hi + a * (lo - hi)) ** p.rho_train).astype(np.float32)
    return [{"sign": np.where(rng.random((B, 1)) < 0.5, -1.0, 1.0).astype(np.float32),
             "sigma": sigma,
             "noise": (rng.standard_normal((B, L)) * sigma[:, None]).astype(np.float32)}]


def phase_train_kernel(torch, fa):
    log(f"== phase 6a: kernel vs plain at batch {TRAIN_BATCH}, f32, tanh (training shapes): "
        "forward and the autograd.Function's dx, dinv, dmod")
    gen = torch.Generator(device="cuda").manual_seed(6)
    worst = 0.0
    for R, C in LARGEST:
        B = TRAIN_BATCH
        x = torch.randn((B, R, C), generator=gen, device="cuda")
        inv = torch.rand(B, C, generator=gen, device="cuda") + 0.5
        mod = torch.rand(B, C, generator=gen, device="cuda") + 0.5
        g = torch.randn(x.shape, generator=gen, device="cuda")
        res = {}
        for name, fn in (("kernel", fa._Fused.apply), ("plain", fa.fused_plain)):
            ts = [t.clone().requires_grad_(True) for t in (x, inv, mod)]
            y = fn(*ts, "tanh")
            res[name] = (y.detach(), torch.autograd.grad(y, ts, g))
        (y, gk), (yp, gp) = res["kernel"], res["plain"]
        err = (y - yp).abs().max().item()
        ok = bool(((y - yp).abs() <= 1e-5 + 1e-5 * yp.abs()).all())
        gerr = {n: ((a - b).abs().max() / b.abs().max()).item()
                for n, a, b in zip(("dx", "dinv", "dmod"), gk, gp)}
        log(json.dumps({"check": "fused_adaln_train", "dtype": "float32", "gelu": "tanh",
                        "shape": [B, R, C], "max_abs_err": err, "fwd_ok": ok,
                        "grad_rel_err": gerr, "grad_tol": 1e-4}))
        if not ok or not max(gerr.values()) <= 1e-4:
            fail(f"kernel disagrees with plain at training shape {(B, R, C)}")
        worst = max(worst, err)
    log("tolerances: forward |d| <= 1e-5 + 1e-5|ref|; dx, dinv, dmod max|d|/max|ref| <= 1e-4 "
        "(dinv and dmod are f32 sums over R rows, taken in another order)")
    return worst


def launches_per_forward(net):
    """Kernel launches of one forward: one per conv prologue (every
    dilation of every AdaLNResBlock with a norm)."""
    from aid_tpu_torch.models.unet_cqt import AdaLNResBlock
    return sum(m.num_dils for m in net.modules() if isinstance(m, AdaLNResBlock) and m.use_norm)


def flagship_trainer(torch, args):
    from aid_tpu_torch import setup as tsetup
    from aid_tpu_torch.models.unet_cqt import MAIN_SCALE
    net = tsetup.setup_network(args, device="cuda", seed=0, trainable=True)
    net.init_weights(0, gate_scale=MAIN_SCALE)      # trained-like gates
    tr = tsetup.setup_trainer(args, network=net, diff_params=tsetup.setup_diff_parameters(args))
    tr.init_state()
    return tr


def phase_train_steps(torch, fa, np, corpus, work, card):
    """6b-6d on the trainer's own methods, TF32 off."""
    from aid_tpu_torch import train as ttrain
    from aid_tpu_torch.training import utils as tutils
    # full learning rate from step 2 (lr_rampup_it=1; step 1 still has lr 0):
    # steps 3-4 then move the parameters by many f32 ulps, so the resumed
    # run's agreement is measured against a real update
    args = ttrain.compose_args(train_overrides(corpus, os.path.join(work, "steps"),
                                               "exp.lr_rampup_it=1"))
    L, B = int(args.exp.audio_len), TRAIN_BATCH
    batches = mixed_batches(np, args, 4)
    tr = flagship_trainer(torch, args)
    per_fwd = launches_per_forward(tr.net)
    rng = np.random.default_rng(7)
    draws = [numpy_draws(np, tr.p, rng, B, L) for _ in batches]
    audio, fs = batches[0]

    x = torch.from_numpy(audio).cuda()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    y = tutils.resample_batch(x, fs, int(args.exp.sample_rate))
    torch.cuda.synchronize()
    log(json.dumps({"check": "resample_batch", "form": "polyphase (unfold + matmul)",
                    "rates": [int(v) for v in fs], "in_shape": list(x.shape),
                    "finite": bool(torch.isfinite(y).all()),
                    "peak_extra_mb": (torch.cuda.max_memory_allocated() - base) / 2 ** 20}))
    del x, y

    log("== phase 6b: one training step, kernel vs plain (full width, batch 4, f32, "
        "mixed 44.1/48 kHz batch)")
    p0 = [p.detach().clone() for p in tr.params]
    out = {}
    for plain in (False, True):
        with plain_forced(fa) if plain else contextlib.nullcontext():
            tr.init_state()
            torch.cuda.synchronize()
            fa.reset_launch_count()
            t0 = time.time()
            m = tr.train_step(audio, fs, draws[0])
            out[plain] = (float(m["loss"]), float(m["grad_norm"]), fa.launch_count(),
                          time.time() - t0)
        unchanged = all(torch.equal(a, b) for a, b in zip(tr.params, p0))
        if not unchanged:
            fail("the first training step moved the parameters (lr must be 0)")
    (lk, gk, nk, _), (lp, gp, n_plain, _) = out[False], out[True]
    rec = {"check": "train_step", "loss": lk, "plain_loss": lp, "grad_norm": gk,
           "plain_grad_norm": gp, "loss_rel_err": abs(lk - lp) / abs(lp),
           "grad_norm_rel_err": abs(gk - gp) / abs(gp), "tol": 1e-4,
           "launches": nk, "plain_launches": n_plain, "params_unchanged_after_step_1": True}
    log(json.dumps(rec))
    if not (math.isfinite(lk) and math.isfinite(gk) and rec["loss_rel_err"] <= 1e-4
            and rec["grad_norm_rel_err"] <= 1e-4):
        fail(f"training step, kernel vs plain: {rec}")
    if nk != 2 * per_fwd or n_plain != 0:
        fail(f"expected {2 * per_fwd} kernel launches in a remat training step: {rec}")

    log("== phase 6c: gradients with remat 'block' and 'conv' against no remat (TF32 off); "
        "time and peak memory of each with TF32 off and on")
    net = tr.net

    def fwd_bwd(mode, tf32):
        net.remat, net.remat_policy = mode != "none", "block" if mode == "none" else mode
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            torch.cuda.synchronize()
            resident = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            fa.reset_launch_count()
            t0 = time.time()
            loss, _, _, g = tr.loss_and_grads(audio[None], fs[None], draws[0])
            float(loss)
            torch.cuda.synchronize()
        finally:
            torch.backends.cudnn.allow_tf32 = False
        return g, {"peak_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
                   "resident_gb": resident / 2 ** 30, "launches": fa.launch_count(),
                   "forward_backward_s": time.time() - t0}

    grads, mem = {}, {}
    for mode in ("none", "block", "conv"):
        g, off = fwd_bwd(mode, False)
        grads[mode] = [t.clone() for t in g]
        del g
        _, on = fwd_bwd(mode, True)
        mem[mode] = {"tf32_off": off, "tf32_on": on}
        if off["launches"] != per_fwd * (1 if mode == "none" else 2):
            fail(f"launches per forward and backward, remat {mode}: {off}")
    net.remat, net.remat_policy = True, "block"
    scale = max(t.abs().max().item() for t in grads["none"])
    for mode in ("block", "conv"):
        err = max((a - b).abs().max().item() for a, b in zip(grads[mode], grads["none"])) / scale
        rec = {"check": "remat_grads", "policy": mode, "grad_rel_err": err, "tol": 1e-4,
               **mem[mode], "no_remat": mem["none"], "card": card}
        log(json.dumps(rec))
        if not err <= 1e-4:
            fail(f"remat {mode} gradients differ from no remat: {rec}")
    del grads

    log("== phase 6d: 4 steps; a fresh trainer resumed from the step-2 checkpoint takes "
        "steps 3-4 on the same batches and draws")
    tr.init_state()
    times, path, p2 = [], None, None
    for i, ((a, f), d) in enumerate(zip(batches, draws)):
        torch.cuda.synchronize()
        t0 = time.time()
        m = tr.train_step(a, f, d)
        if not math.isfinite(float(m["loss"])):
            fail(f"non-finite loss at step {tr.it}")
        torch.cuda.synchronize()
        times.append(time.time() - t0)
        if tr.it == 2:
            path = tr.save_checkpoint()
            p2 = [p.detach().clone() for p in tr.params]
    whole = [p.detach().clone() for p in tr.params]
    del tr, net
    gc.collect()
    torch.cuda.empty_cache()
    tr2 = flagship_trainer(torch, args)
    if not tr2.resume_from_checkpoint(path) or tr2.it != 2:
        fail("the step-2 checkpoint did not resume")
    for (a, f), d in list(zip(batches, draws))[2:]:
        tr2.train_step(a, f, d)
    moved = max((b - a).abs().max().item() for a, b in zip(p2, whole))
    dev = max((a - b).abs().max().item() for a, b in zip(tr2.params, whole))
    num = sum(((a - b).double() ** 2).sum().item() for a, b in zip(tr2.params, whole))
    den = sum(((b - a).double() ** 2).sum().item() for a, b in zip(p2, whole))
    rec = {"check": "resume_continues", "steps_3_4_max_move": moved, "max_abs_dev": dev,
           "update_rel_l2": (num / den) ** 0.5 if den else float("inf"),
           "tol": {"max_abs_dev": "0.1 x max move", "update_rel_l2": 1e-3},
           "step_s": times, "card": card}
    log(json.dumps(rec))
    if not (moved > 0 and dev <= 0.1 * moved and rec["update_rel_l2"] <= 1e-3):
        fail(f"resumed training left the uninterrupted run: {rec}")
    del tr2, p2, whole
    gc.collect()
    torch.cuda.empty_cache()
    return {"step_s_tf32_off": float(np.median(times[1:])), "peak_gb": mem,
            "launches_per_step": 2 * per_fwd, "launches_per_forward": per_fwd}


def phase_train_entry(torch, fa, np, corpus, work, card):
    """6e: the entry point, twice; launches counted from the first main to
    the end of the second."""
    from aid_tpu_torch import train as ttrain
    from aid_tpu_torch.training.trainer import Trainer
    from aid_tpu_torch.utils import checkpoint as ckpt
    log("== phase 6e: aid_tpu_torch.train.main, 4 steps from the corpus, then a resumed main")
    md = os.path.join(work, "main")
    ov = train_overrides(corpus, md, "exp.total_its=4", "logging.save_interval=2",
                         "logging.log_interval=1", "logging.remove_last_checkpoint=False")
    steps, expect = [], {}
    orig = Trainer.train_step

    def timed(self, audio, fs, draws=None):
        it0 = self.it
        if "resumed_from" in expect and not any(s["run"] == 2 for s in steps):
            ref = expect["resumed_from"]
            same = it0 == ref["it"] and int(self.count) == ref["optimizer"]["count"] and all(
                torch.equal(p.detach().cpu(), ref["network"][n])
                for n, p in zip(self.names, self.params))
            if not same:
                fail("the resumed main does not hold the step-2 checkpoint's state")
        before = [p.detach().clone() for p in self.params] if it0 < 2 else None
        torch.cuda.synchronize()
        n0 = fa.launch_count()
        t0 = time.time()
        m = orig(self, audio, fs, draws)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        rec = {"run": 2 if "resumed_from" in expect else 1, "it": self.it,
               "wall_s": time.time() - t0, "launches": fa.launch_count() - n0,
               "expected_launches": launches_per_forward(self.net) * (2 if self.net.remat else 1),
               "remat": bool(self.net.remat), "loss": loss, "rates": sorted({int(v) for v in fs})}
        if before is not None:
            rec["params_changed"] = any(not torch.equal(a, b)
                                        for a, b in zip(before, self.params))
        steps.append(rec)
        log(json.dumps({"train_step": rec}))
        return m

    torch.backends.cudnn.allow_tf32 = True       # the training default (README, TF32)
    Trainer.train_step = timed
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_count()                  # the training main path starts here
        t0 = time.time()
        if ttrain.main(ov) != 0:
            fail("train.main returned non-zero")
        wall1 = time.time() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        gc.collect()
        torch.cuda.empty_cache()
        names = [os.path.basename(p) for p in ckpt.list_checkpoints(md, "22k_8s")]
        if names != ["22k_8s-2.pt", "22k_8s-4.pt"]:
            fail(f"checkpoints after the first main: {names}")
        expect["resumed_from"] = ckpt.load(os.path.join(md, "22k_8s-2.pt"))
        os.remove(os.path.join(md, "22k_8s-4.pt"))
        if ttrain.main(ov) != 0:
            fail("the resumed train.main returned non-zero")
        launches = fa.launch_count()             # ... and ends here
    finally:
        Trainer.train_step = orig
        torch.backends.cudnn.allow_tf32 = False
    del expect["resumed_from"]
    gc.collect()
    torch.cuda.empty_cache()
    final = ckpt.load(os.path.join(md, "22k_8s-4.pt"))
    run1 = [s for s in steps if s["run"] == 1]
    run2 = [s for s in steps if s["run"] == 2]
    rec = {"check": "train_entry", "steps_run1": [s["it"] for s in run1],
           "steps_run2": [s["it"] for s in run2], "final_it": final["it"],
           "final_count": final["optimizer"]["count"],
           "launches": launches, "launches_per_step": sorted({s["launches"] for s in steps}),
           "mixed_rate_steps": sum(len(s["rates"]) > 1 for s in steps),
           "step_s_median_after_first": float(np.median([s["wall_s"] for s in run1[1:]])),
           "run1_wall_s": wall1, "peak_gb": peak, "tf32_convs": True, "card": card}
    log(json.dumps(rec))
    ok = (rec["steps_run1"] == [1, 2, 3, 4] and rec["steps_run2"] == [3, 4]
          and final["it"] == 4 and final["optimizer"]["count"] == 4
          and all(math.isfinite(s["loss"]) for s in steps)
          and run1[0]["params_changed"] is False and run1[1]["params_changed"] is True
          and all(s["remat"] and s["launches"] == s["expected_launches"] for s in steps)
          and launches == sum(s["launches"] for s in steps)
          and rec["mixed_rate_steps"] > 0
          and all(torch.isfinite(v).all() for v in final["network"].values()))
    if not ok:
        fail(f"training entry point: {rec}")
    return rec


def phase_training(torch, fa, np, work, card, shapes):
    """Phase 6 in ``work``; the corpus and phase 6e's checkpoints stay there
    for phase 8."""
    from aid_tpu_torch.utils.config import compose
    log("== phase 6: training at full flagship width, batch 4, f32")
    corpus = os.path.join(work, "maestro")
    args = compose()
    write_corpus(np, corpus, int(args.dset.load_len),
                 int(args.exp.audio_len * args.exp.resample_factor))
    worst = phase_train_kernel(torch, fa)
    log(f"== phase 6a, timing: kernel at every launch shape at batch {TRAIN_BATCH}, f32, "
        "tanh, over one training forward")
    timing = time_kernel(torch, fa, shapes, "tanh", torch.float32, [TRAIN_BATCH],
                         time_batch=TRAIN_BATCH)
    log(json.dumps({"timing": "fused_adaln_fwd per training forward (f32, batch 4)",
                    **timing, "card": card}))
    worst = max(worst, timing["max_abs_err"])
    steps = phase_train_steps(torch, fa, np, corpus, work, card)
    entry = phase_train_entry(torch, fa, np, corpus, work, card)
    log(json.dumps({"training": {"kernel_ms_per_forward": timing["ms"],
                                 "kernel_bound_ms_per_forward": timing["bound_ms"],
                                 "step_s_entry_tf32": entry["step_s_median_after_first"],
                                 "step_s_tf32_off": steps["step_s_tf32_off"],
                                 "peak_gb_entry": entry["peak_gb"],
                                 "peak_gb_by_remat": {
                                     k: {t: v[t]["peak_gb"] for t in v}
                                     for k, v in steps["peak_gb"].items()},
                                 "launches_per_step": steps["launches_per_step"],
                                 "launches_per_forward": steps["launches_per_forward"],
                                 "card": card}}))
    return entry["launches"], worst


# ------------------------------------------------------- multi-device (7)

PAR_WORLD = 2              # ranks of phase 7b-7g, sharing the one card over gloo
F32_TOL = 1e-4             # f32 (TF32 off) comparisons of phase 7, max|d| / max|ref|
# 7g's service: the served flagship at 4 deterministic steps
SERVE_CP = ["tester.T=4", "tester.diff_params.same_as_training=False",
            "tester.diff_params.Schurn=0.0"]


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_env(rank, world, port):
    return {"RANK": str(rank), "WORLD_SIZE": str(world), "LOCAL_RANK": str(rank),
            "LOCAL_WORLD_SIZE": str(world), "MASTER_ADDR": "localhost",
            "MASTER_PORT": str(port)}


def rel(a, b):
    return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()


def phase_parallel_entry(torch, fa, corpus, work, card):
    """7a: aid_tpu_torch.train.main with exp.mesh.fsdp over NCCL, one rank
    per card, 2 steps; its launches are counted."""
    import torch.distributed as dist
    from aid_tpu_torch import train as ttrain
    from aid_tpu_torch.training.trainer import Trainer
    from aid_tpu_torch.utils import checkpoint as ckpt
    world = 1
    log(f"== phase 7a: aid_tpu_torch.train.main, exp.mesh.fsdp=true, over NCCL at world size "
        f"{world} ({torch.cuda.device_count()} card(s)), 2 steps")
    md = os.path.join(work, "fsdp_main")
    ov = train_overrides(corpus, md, "exp.total_its=2", "logging.save_interval=2",
                         "logging.log_interval=1", "exp.mesh.distributed=True",
                         "exp.mesh.fsdp=True")
    steps, orig = [], Trainer.train_step

    def timed(self, audio, fs, draws=None):
        torch.cuda.synchronize()
        n0, t0 = fa.launch_count(), time.time()
        m = orig(self, audio, fs, draws)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        steps.append({"it": self.it, "wall_s": time.time() - t0, "loss": loss,
                      "launches": fa.launch_count() - n0, "backend": dist.get_backend(),
                      "world": dist.get_world_size(), "fsdp": self.fsdp,
                      "sharded_tensors": sum(d is not None for d in self.shard_dims)})
        log(json.dumps({"train_step": steps[-1]}))
        return m

    saved = {k: os.environ.get(k) for k in rank_env(0, 1, 0)}
    os.environ.update(rank_env(0, world, free_port()))
    Trainer.train_step = timed
    torch.backends.cudnn.allow_tf32 = True       # the training default (README, TF32)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_count()                  # 7a's main path starts here
        if ttrain.main(ov) != 0:
            fail("the fsdp train.main returned non-zero")
        launches = fa.launch_count()             # ... and ends here
    finally:
        Trainer.train_step = orig
        torch.backends.cudnn.allow_tf32 = False
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    final = ckpt.load(os.path.join(md, "22k_8s-2.pt"))
    per_step = 2 * 90
    rec = {"check": "fsdp_train_entry", "steps": [s["it"] for s in steps],
           "backend": steps[0]["backend"] if steps else None, "world": world,
           "group_ended": not dist.is_initialized(), "launches": launches,
           "expected_launches": 2 * per_step, "step_s": [s["wall_s"] for s in steps],
           "peak_gb": peak, "checkpoint_it": final["it"],
           "checkpoint_full_shapes": all(t.dim() > 0 for t in final["network"].values()),
           "card": card}
    log(json.dumps(rec))
    if not (rec["steps"] == [1, 2] and rec["backend"] == "nccl" and rec["group_ended"]
            and all(s["fsdp"] and s["sharded_tensors"] == 0 for s in steps)
            and launches == 2 * per_step and final["it"] == 2
            and all(math.isfinite(s["loss"]) for s in steps)):
        fail(f"fsdp training entry point: {rec}")
    return rec


def one_rank_steps(torch, np, corpus, work):
    """7b's reference: the one-rank trainer's 2 steps (TF32 off) on a
    global batch of 4 and its draws."""
    from aid_tpu_torch import train as ttrain
    args = ttrain.compose_args(train_overrides(corpus, os.path.join(work, "ref"),
                                               "exp.lr_rampup_it=1"))
    batches = mixed_batches(np, args, 2)
    tr = flagship_trainer(torch, args)
    rng = np.random.default_rng(11)
    draws = [numpy_draws(np, tr.p, rng, TRAIN_BATCH, int(args.exp.audio_len)) for _ in batches]
    p0 = [p.detach().cpu() for p in tr.params]
    ref = {"loss": [], "grad_norm": []}
    for (a, f), d in zip(batches, draws):
        m = tr.train_step(a, f, d)
        ref["loss"].append(float(m["loss"]))
        ref["grad_norm"].append(float(m["grad_norm"]))
    ref["params"] = [p.detach().cpu() for p in tr.params]
    ref["p0"] = p0
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return batches, draws, ref


def run_ranks(torch, np, work, inputs, timeout=900):
    """Start PAR_WORLD copies of this script as the ranks of a process group
    (``--rank R WORKDIR``); returns their JSON results. A rank that fails or
    outlives ``timeout`` fails the phase; no rank is left running."""
    import pickle
    import subprocess
    os.makedirs(work, exist_ok=True)
    with open(os.path.join(work, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    port = free_port()
    procs = []
    for r in range(PAR_WORLD):
        env = dict(os.environ, **rank_env(r, PAR_WORLD, port))
        with open(os.path.join(work, f"rank{r}.log"), "w") as out:
            procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank",
                                           str(r), work], env=env, stdout=out,
                                          stderr=subprocess.STDOUT))
    try:
        deadline = time.time() + timeout
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.time()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        text = open(os.path.join(work, f"rank{r}.log")).read()
        for line in text.splitlines():
            if line.startswith(("[mesh]", "[setup]", "[ring]")):
                log(f"rank {r}: {line}")
        if p.returncode != 0:
            log(text[-8000:])
            fail(f"phase 7 rank {r} exited {p.returncode}")
    return [json.load(open(os.path.join(work, f"rank{r}.json"))) for r in range(PAR_WORLD)]


def rank_main(rank, work):
    """One rank of phase 7b-7g: a process group over gloo (two ranks share
    the card), the kernel against its plain version, then each path with
    the launch count set to 0 before it and read after it."""
    import pickle

    import numpy as np
    import torch
    import torch.distributed as dist
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(here, ".triton_cache"))
    from aid_tpu_torch.ops import fused_adaln as fa
    from aid_tpu_torch.parallel import mesh as pmesh
    from aid_tpu_torch.setup import resolve_device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(os.path.join(work, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    pmesh.init_distributed(enable=True)
    world = dist.get_world_size()
    out = {"rank": rank, "world": world, "backend": dist.get_backend(),
           "device": str(resolve_device())}
    gen = torch.Generator(device="cuda").manual_seed(100 + rank)
    x = torch.randn((1, 14336, 256), generator=gen, device="cuda").to(torch.bfloat16)
    inv = torch.rand(1, 256, generator=gen, device="cuda") + 0.5
    mod = torch.rand(1, 256, generator=gen, device="cuda") + 0.5
    with torch.no_grad():
        y, yp = fa._fused_cuda(x, inv, mod, "tanh"), fa.fused_plain(x, inv, mod, "tanh")
    out["kernel_vs_plain"] = {"ok": bf16_ulp_ok(y, yp),
                              "max_abs_err": (y.float() - yp.float()).abs().max().item()}
    out["train"] = rank_train(torch, fa, np, inp, rank, world, work)
    out["serve"] = rank_serve(torch, fa, np, inp)
    out["tp"], out["cp"] = rank_scores(torch, fa)
    out["full_cp"] = rank_full_cp(torch, fa)
    out["serve_cp"] = rank_serve_cp(torch, fa, np, inp)
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def rank_train(torch, fa, np, inp, rank, world, work):
    """7b: 2 DDP steps and 2 FSDP steps on this rank's rows of the global
    batch and draws (TF32 off); rank 0 keeps the gathered parameters."""
    from aid_tpu_torch import train as ttrain
    res = {}
    k = TRAIN_BATCH // world
    rows = slice(rank * k, (rank + 1) * k)
    for mode, extra in (("dp", []), ("fsdp", ["exp.mesh.fsdp=True"])):
        args = ttrain.compose_args(train_overrides(
            inp["corpus"], os.path.join(work, mode), "exp.lr_rampup_it=1",
            f"exp.mesh.dp={world}", *extra))
        tr = flagship_trainer(torch, args)
        rec = {"wrapper": type(tr.model).__name__, "loss": [], "grad_norm": [], "step_s": []}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_count()                  # 7b's path starts here
        for (a, f), d in zip(inp["batches"], inp["draws"]):
            t0 = time.time()
            m = tr.train_step(a[rows], f[rows], [{n: v[rows] for n, v in d[0].items()}])
            rec["loss"].append(float(m["loss"]))
            rec["grad_norm"].append(float(m["grad_norm"]))
            torch.cuda.synchronize()
            rec["step_s"].append(time.time() - t0)
        rec["launches"] = fa.launch_count()      # ... and ends here
        rec["expected_launches"] = len(inp["batches"]) * 2 * launches_per_forward(tr.net)
        rec["peak_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
        rec["resident_gb"] = torch.cuda.memory_allocated() / 2 ** 30
        state = tr.state_dict()
        if state is not None:
            torch.save(state["network"], os.path.join(work, f"{mode}_params.pt"))
        res[mode] = rec
        del tr, state
        gc.collect()
        torch.cuda.empty_cache()
    return res


def rank_serve(torch, fa, np, inp):
    """7c: phase 5's request (b) served by shard() over dp (one row of each
    2-row round per rank)."""
    from aid_tpu_torch.models.unet_cqt import MAIN_SCALE
    from aid_tpu_torch.serving import InpaintingService
    svc = InpaintingService.from_config([])
    svc.network.init_weights(0, gate_scale=MAIN_SCALE)   # phase 5's weights
    svc.shard()
    rounds, run = [], svc._run_batch

    def counted(xb, mb, seed):
        rounds.append(xb.shape[0])
        return run(xb, mb, seed)

    svc._run_batch = counted
    req = inp["request_b"]
    torch.cuda.synchronize()
    fa.reset_launch_count()                      # 7c's path starts here
    t0 = time.time()
    got = svc.inpaint(req["audio"], req["mask"], req["fs"], seed=1)
    wall = time.time() - t0
    launches = fa.launch_count()                 # ... and ends here
    ref = torch.from_numpy(req["answer"])
    obs = req["mask"] > 0.5
    steps = 2 * svc.sampler.cfg.T - 1
    rec = {"rounds": rounds, "max_batch": svc.max_batch, "wall_s": wall,
           "rtf": len(req["audio"]) / req["fs"] / wall, "rel_err": rel(torch.from_numpy(got), ref),
           "observed_exact": bool(np.array_equal(got[obs], req["audio"][obs])),
           "finite": bool(np.isfinite(got).all()), "launches": launches,
           "expected_launches": 90 * steps * len(rounds)}
    del svc
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def rank_scores(torch, fa):
    """7d and 7e: one f32 guided score (batch 1, TF32 off) of the flagship
    replicated and with its conv and dense layers split over tp=2; then one
    of the flagship with attention_dict.context_parallel, without and with
    the cp=2 mesh."""
    from aid_tpu_torch.parallel import ring_attention as ring
    from aid_tpu_torch.parallel import tp
    from aid_tpu_torch.tools.profile_denoiser import flagship_case

    def score(case):
        torch.cuda.synchronize()
        n0, t0 = fa.launch_count(), time.time()
        s = case.score(case.audio, case.sigma[0])
        torch.cuda.synchronize()
        return s, time.time() - t0, fa.launch_count() - n0

    out = {}
    for name in ("tp", "cp"):
        case = flagship_case("float32", 1, overrides=(
            ["network.attention_dict.context_parallel=True"] if name == "cp" else []))
        score(case)                              # warm: Triton variants, cuDNN, CQT tables
        fa.reset_launch_count()                  # 7d / 7e's path starts here
        ref, ref_s, ref_n = score(case)
        calls, dense = [], ring.ring_attention
        if name == "tp":
            tp.place_params(case.net, tp.make_tp_mesh(PAR_WORLD))
            split, _, _ = score(case)            # warm the split layers
            got, got_s, got_n = score(case)
        else:
            def counted(*a, **k):
                calls.append(a[0].shape[2])
                return dense(*a, **k)
            ring.ring_attention = counted
            ring.set_cp_mesh(ring.make_cp_mesh(PAR_WORLD))
            try:
                score(case)
                calls.clear()
                got, got_s, got_n = score(case)
            finally:
                ring.set_cp_mesh(None)
                ring.ring_attention = dense
        out[name] = {"rel_err": rel(got, ref), "tol": F32_TOL, "replicated_s": ref_s,
                     f"{name}_s": got_s, "launches": fa.launch_count(),   # ... and ends here
                     "launches_per_score": [ref_n, got_n], "ring_calls": calls,
                     "finite": bool(torch.isfinite(got).all())}
        del case, ref, got
        gc.collect()
        torch.cuda.empty_cache()
    return out["tp"], out["cp"]


def rank_full_cp(torch, fa):
    """7f: full-score context parallelism over cp=2 (f32, batch 1, TF32
    off): denoiser output, input gradient and one guided score of the
    flagship with both cp flags, replicated (no mesh) and split."""
    from aid_tpu_torch.diffusion import edm
    from aid_tpu_torch.parallel import cp as cpmod
    from aid_tpu_torch.parallel import ring_attention as ring
    from aid_tpu_torch.tools.profile_denoiser import flagship_case
    case = flagship_case("float32", 1, overrides=[
        "network.context_parallel=True", "network.attention_dict.context_parallel=True"])
    p, audio, sigma = case.sampler.p, case.audio, case.sigma

    def run():
        torch.cuda.synchronize()
        n0, t0 = fa.launch_count(), time.time()
        x = audio.clone().requires_grad_(True)
        d = edm.denoiser(p, case.net, x, sigma)
        (g,) = torch.autograd.grad((d.float() ** 2).sum(), x)
        t1 = time.time()
        s = case.score(audio, sigma[0])
        torch.cuda.synchronize()
        return d.detach(), g, s, time.time() - t1, fa.launch_count() - n0

    run()                                        # warm: Triton variants, cuDNN, CQT tables
    fa.reset_launch_count()                      # 7f's path starts here
    d0, g0, s0, rep_s, rep_n = run()
    ring.set_cp_mesh(ring.make_cp_mesh(PAR_WORLD))
    try:
        run()
        cpmod.reset_counts()
        d1, g1, s1, cp_s, cp_n = run()
        counts = cpmod.counts()
    finally:
        ring.set_cp_mesh(None)
    rec = {"denoiser_rel_err": rel(d1, d0), "input_grad_rel_err": rel(g1, g0),
           "guided_score_rel_err": rel(s1, s0), "tol": F32_TOL, "replicated_s": rep_s,
           "cp_s": cp_s, "launches": fa.launch_count(),   # ... and ends here
           "launches_per_run": [rep_n, cp_n],
           # one run: a denoiser forward and backward, then a guided score
           # (a forward and a backward): twice one score's exchanges
           "exchanges_per_run": counts,
           "exchanges_per_score": {k: v / 2 for k, v in counts.items()},
           "finite": bool(torch.isfinite(s1).all() and torch.isfinite(g1).all())}
    del case
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def rank_serve_cp(torch, fa, np, inp):
    """7g: phase 5's request (a) at tester.T=4, Schurn=0 by the one-rank
    service, then by the same service after shard() over (dp=1, cp=2)."""
    from aid_tpu_torch.models.unet_cqt import MAIN_SCALE
    from aid_tpu_torch.parallel import cp as cpmod
    from aid_tpu_torch.parallel import ring_attention as ring
    from aid_tpu_torch.serving import InpaintingService
    svc = InpaintingService.from_config(SERVE_CP)
    svc.network.init_weights(0, gate_scale=MAIN_SCALE)   # phase 5's weights
    req = inp["request_a"]
    ref = svc.inpaint(req["audio"], req["mask"], req["fs"], seed=1)
    svc.shard(ring.make_cp_mesh(PAR_WORLD, n_dp=1))
    try:
        torch.cuda.synchronize()
        cpmod.reset_counts()
        fa.reset_launch_count()                  # 7g's path starts here
        t0 = time.time()
        got = svc.inpaint(req["audio"], req["mask"], req["fs"], seed=1)
        wall = time.time() - t0
        launches = fa.launch_count()             # ... and ends here
        counts = cpmod.counts()
    finally:
        ring.set_cp_mesh(None)
    obs = req["mask"] > 0.5
    steps = 2 * svc.sampler.cfg.T - 1
    rec = {"T": svc.sampler.cfg.T, "wall_s": wall, "rtf": len(req["audio"]) / req["fs"] / wall,
           "rel_err": rel(torch.from_numpy(got), torch.from_numpy(ref)),
           "observed_exact": bool(np.array_equal(got[obs], req["audio"][obs])),
           "finite": bool(np.isfinite(got).all()), "launches": launches,
           "expected_launches": 90 * steps, "levels_sharded": counts.get("levels_sharded", 0),
           "levels_replicated": counts.get("levels_replicated", 0)}
    del svc
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def phase_parallel(torch, fa, np, work, card, request_a, request_b):
    """Phase 7: 7a in this process; 7b-7g on PAR_WORLD ranks sharing the
    card (gloo), held against one rank."""
    log("== phase 7: multi-device training and serving over torch.distributed")
    corpus = os.path.join(work, "maestro")
    t_phase = time.time()
    entry = phase_parallel_entry(torch, fa, corpus, work, card)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"== phase 7b reference: the one-rank trainer's 2 steps at batch {TRAIN_BATCH}, f32, "
        "TF32 off")
    batches, draws, ref = one_rank_steps(torch, np, corpus, work)
    log(f"== phase 7b-7g: {PAR_WORLD} ranks on one card over gloo: dp and fsdp steps, "
        "shard() over dp on phase 5's request (b), a tp=2 and a cp=2 guided score, a "
        "full-score cp=2 score, shard() over (dp=1, cp=2) on phase 5's request (a) at T=4")
    t0 = time.time()
    ranks = run_ranks(torch, np, os.path.join(work, "ranks"),
                      {"corpus": corpus, "batches": batches, "draws": draws,
                       "request_a": request_a, "request_b": request_b})
    ranks_wall = time.time() - t0
    launches, problems = entry["launches"], []
    for r in ranks:
        log(json.dumps({"rank": r["rank"], "backend": r["backend"], "world": r["world"],
                        "device": r["device"], "kernel_vs_plain": r["kernel_vs_plain"]}))
        if not (r["backend"] == "gloo" and r["world"] == PAR_WORLD
                and r["kernel_vs_plain"]["ok"]):
            problems.append(f"rank {r['rank']}: route or kernel check")
    summary = {}
    for mode in ("dp", "fsdp"):
        got = torch.load(os.path.join(work, "ranks", f"{mode}_params.pt"))
        whole = ref["params"]
        names = list(got)
        moved = max((b - a).abs().max().item() for a, b in zip(ref["p0"], whole))
        dev = max((got[n] - b).abs().max().item() for n, b in zip(names, whole))
        num = sum(((got[n] - b).double() ** 2).sum().item() for n, b in zip(names, whole))
        den = sum(((b - a).double() ** 2).sum().item() for a, b in zip(ref["p0"], whole))
        recs = [r["train"][mode] for r in ranks]
        rec = {"check": f"{mode}_steps", "wrapper": recs[0]["wrapper"],
               "loss": recs[0]["loss"], "one_rank_loss": ref["loss"],
               "grad_norm": recs[0]["grad_norm"], "one_rank_grad_norm": ref["grad_norm"],
               "loss_rel_err": max(abs(a - b) / abs(b) for a, b in zip(recs[0]["loss"],
                                                                     ref["loss"])),
               "grad_norm_rel_err": max(abs(a - b) / abs(b) for a, b in
                                        zip(recs[0]["grad_norm"], ref["grad_norm"])),
               "update_rel_l2": (num / den) ** 0.5 if den else float("inf"),
               "max_abs_dev": dev, "max_move": moved, "tol": {
                   "loss_and_grad_norm": F32_TOL, "update_rel_l2": 1e-3,
                   "max_abs_dev": "0.1 x max move"},
               "step_s": [r["step_s"] for r in recs], "peak_gb": [r["peak_gb"] for r in recs],
               "resident_gb": [r["resident_gb"] for r in recs],
               "launches": [r["launches"] for r in recs], "card": card}
        log(json.dumps(rec))
        launches += sum(rec["launches"])
        if not (rec["loss_rel_err"] <= F32_TOL and rec["grad_norm_rel_err"] <= F32_TOL
                and rec["update_rel_l2"] <= 1e-3 and dev <= 0.1 * moved
                and all(r["launches"] == r["expected_launches"] for r in recs)):
            problems.append(f"{mode} steps against the one-rank steps")
        summary[mode] = {"step_s": float(np.median([s for r in recs for s in r["step_s"][1:]])),
                         "peak_gb_per_rank": max(rec["peak_gb"]),
                         "resident_gb_per_rank": max(rec["resident_gb"])}
    serve = [r["serve"] for r in ranks]
    rec = {"check": "shard_dp_serving", **serve[0], "tol": BF16_TOL,
           "ranks_agree": all(s["rel_err"] == serve[0]["rel_err"] for s in serve),
           "launches": [s["launches"] for s in serve], "card": card}
    log(json.dumps(rec))
    launches += sum(s["launches"] for s in serve)
    if not (rec["finite"] and rec["observed_exact"] and rec["rel_err"] <= BF16_TOL
            and rec["ranks_agree"] and rec["rounds"] == [2, 2]
            and all(s["launches"] == s["expected_launches"] for s in serve)):
        problems.append("dp serving against the one-rank answer")
    summary["dp_serving_rtf"] = serve[0]["rtf"]
    for name in ("tp", "cp"):
        recs = [r[name] for r in ranks]
        rec = {"check": f"{name}_guided_score", **recs[0],
               "rel_err_by_rank": [r["rel_err"] for r in recs], "card": card}
        log(json.dumps(rec))
        launches += sum(r["launches"] for r in recs)
        if not (all(r["finite"] and r["rel_err"] <= F32_TOL for r in recs)
                and all(r["launches_per_score"] == [90, 90] for r in recs)
                and (name == "tp" or recs[0]["ring_calls"])):
            problems.append(f"{name} guided score against the replicated one")
        summary[name] = {"rel_err": recs[0]["rel_err"], "replicated_s": recs[0]["replicated_s"],
                         f"{name}_s": recs[0][f"{name}_s"]}
    recs = [r["full_cp"] for r in ranks]
    rec = {"check": "full_score_cp_guided_score", **recs[0],
           "guided_score_rel_err_by_rank": [r["guided_score_rel_err"] for r in recs],
           "card": card}
    log(json.dumps(rec))
    launches += sum(r["launches"] for r in recs)
    c = recs[0]["exchanges_per_run"]
    if not (all(r["finite"] and max(r["denoiser_rel_err"], r["input_grad_rel_err"],
                                    r["guided_score_rel_err"]) <= F32_TOL for r in recs)
            and all(r["launches_per_run"] == [180, 180] for r in recs)
            and c.get("levels_sharded") == 2 * 7 and "levels_replicated" not in c
            and c.get("halo", 0) > 0 and c.get("ring", 0) > 0):
        problems.append("full-score cp=2 against the replicated score")
    summary["full_cp"] = {k: recs[0][k] for k in ("guided_score_rel_err", "replicated_s",
                                                   "cp_s")}
    serve = [r["serve_cp"] for r in ranks]
    rec = {"check": "shard_dp1_cp2_serving", **serve[0], "tol": BF16_TOL,
           "ranks_agree": all(s["rel_err"] == serve[0]["rel_err"] for s in serve),
           "launches": [s["launches"] for s in serve], "card": card}
    log(json.dumps(rec))
    launches += sum(s["launches"] for s in serve)
    if not (rec["finite"] and rec["observed_exact"] and rec["rel_err"] <= BF16_TOL
            and rec["ranks_agree"] and rec["levels_replicated"] == 0
            and all(s["launches"] == s["expected_launches"] for s in serve)):
        problems.append("(dp=1, cp=2) serving against the one-rank answer")
    summary["cp_serving_rtf"] = serve[0]["rtf"]
    summary.update(fsdp_entry_step_s=entry["step_s"], fsdp_entry_peak_gb=entry["peak_gb"],
                   ranks_wall_s=ranks_wall, phase_s=time.time() - t_phase, card=card)
    log(json.dumps({"parallel": summary}))
    if problems:
        fail("phase 7: " + "; ".join(problems))
    return launches, max(r["kernel_vs_plain"]["max_abs_err"] for r in ranks)


# -------------------------------------------------------------- evaluation

# steps of the nine other modes, the demo and 8d, cut from the configured 35
# to keep the script within its time budget; the inpainting mode runs T=35
EVAL_T = 4
OTHER_MODES = ["unconditional", "inpainting_mushra", "inpainting_shortgaps",
               "spectrogram_inpainting", "bwe", "declipping", "comp_sens", "phase_retrieval",
               "autoregressive"]


def eval_overrides(corpus, model_dir, *extra):
    return [f"dset.path={corpus}", "dset.test.num_samples=1", f"model_dir={model_dir}", *extra]


@contextlib.contextmanager
def counting_denoiser():
    """Counts ``edm.denoiser`` calls: the samplers look it up at call time."""
    from aid_tpu_torch.diffusion import edm
    orig, calls = edm.denoiser, [0]

    def counted(*a, **k):
        calls[0] += 1
        return orig(*a, **k)

    edm.denoiser = counted
    try:
        yield calls
    finally:
        edm.denoiser = orig


def run_test_main(overrides):
    """``aid_tpu_torch.test.main(overrides)``; returns the Tester it ran."""
    from aid_tpu_torch import test as ttest
    from aid_tpu_torch.testing.tester import Tester
    seen, orig = [], Tester.dodajob

    def dodajob(self):
        seen.append(self)
        return orig(self)

    Tester.dodajob = dodajob
    try:
        if ttest.main(overrides) != 0:
            fail("aid_tpu_torch.test.main returned non-zero")
    finally:
        Tester.dodajob = orig
    return seen[0]


@contextlib.contextmanager
def checked_writes(np):
    """Every wav the tester and the trainer write goes through
    ``logging_utils.write_audio_file`` (looked up at call time): each
    signal is checked finite before it is quantised to 16 bits, where a NaN
    would no longer show. Yields the list of written paths."""
    from aid_tpu_torch.utils import logging_utils as logu
    orig, written = logu.write_audio_file, []

    def write(x, fs, name, path=".", **k):
        if not np.isfinite(np.asarray(x)).all():
            fail(f"non-finite audio written as {os.path.join(path, name)}")
        written.append(orig(x, fs, name, path, **k))
        return written[-1]

    logu.write_audio_file = write
    try:
        yield written
    finally:
        logu.write_audio_file = orig


def check_metrics(root):
    """Every metrics.json under ``root`` with finite mean LSD and SNR;
    returns their number."""
    scored = 0
    for d, _, files in os.walk(root):
        if "metrics.json" in files:
            with open(os.path.join(d, "metrics.json")) as fh:
                mean = json.load(fh)["__mean__"]
            if not (math.isfinite(mean["lsd"]) and math.isfinite(mean["snr"])):
                fail(f"{d}/metrics.json: {mean}")
            scored += 1
    return scored


def phase_testing(torch, fa, np, work, card):
    """8a-8c on the main path (launches counted), then 8d."""
    from aid_tpu_torch import train as ttrain
    from aid_tpu_torch.data import audio_io
    from aid_tpu_torch.utils import checkpoint as ckpt
    corpus, md = os.path.join(work, "maestro"), os.path.join(work, "main")
    latest = ckpt.list_checkpoints(md, "22k_8s")[-1]
    ema = ckpt.load(latest)["ema"]
    log(f"== phase 8a: aid_tpu_torch.test.main, inpainting at T=35 on one test file, weights "
        f"from the latest checkpoint in {md}")
    torch.cuda.synchronize()
    fa.reset_launch_count()                      # the evaluation main path starts here
    with counting_denoiser() as calls, checked_writes(np) as written:
        t0 = time.time()
        ta = run_test_main(eval_overrides(corpus, md, "tester.modes=['inpainting']"))
        wall_a, calls_a = time.time() - t0, calls[0]
        log(f"== phase 8b: aid_tpu_torch.test.main, the other nine modes at T={EVAL_T}")
        t0 = time.time()
        tb = run_test_main(eval_overrides(
            corpus, md, f"tester.T={EVAL_T}", f"tester.modes={OTHER_MODES}".replace(" ", ""),
            "tester.unconditional.num_samples=1", "tester.autoregressive.num_samples=2"))
        wall_b, calls_b = time.time() - t0, calls[0] - calls_a
        log("== phase 8c: aid_tpu_torch.train.main, one step with heavy_log_interval 1 (the "
            "in-training demo)")
        demo_md = os.path.join(work, "demo")
        t0 = time.time()
        if ttrain.main(train_overrides(corpus, demo_md, "exp.total_its=1",
                                       "logging.heavy_log_interval=1", f"tester.T={EVAL_T}",
                                       "tester.unconditional.num_samples=1")) != 0:
            fail("the demo's train.main returned non-zero")
        wall_c, calls_c = time.time() - t0, calls[0] - calls_a - calls_b
    torch.cuda.synchronize()
    launches = fa.launch_count()                 # ... and ends here

    loaded = all(torch.equal(p, ema[n].to(p.dtype).to(p.device))
                 for n, p in ta.network.named_parameters())
    # trajectories of 8b: unconditional 1, MUSHRA 4, short gaps, spectrogram,
    # bwe, declipping, comp_sens, phase retrieval 1 each, autoregressive 2
    trajectories_b = 1 + 4 + 6 + 2
    expect_calls = {"a": 2 * 35 - 1, "b": (2 * EVAL_T - 1) * trajectories_b,
                    "c": 2 * EVAL_T - 1}
    got_calls = {"a": calls_a, "b": calls_b, "c": calls_c}
    per_fwd = launches_per_forward(ta.network)                  # 90 on the flagship
    expected_launches = per_fwd * (sum(got_calls.values()) + 2)  # + one remat training step
    base = ta.base_dir
    scored = check_metrics(base)
    demo_wav = os.path.join(demo_md, "heavy_logging", "it_1", "uncond_0.wav")
    if demo_wav not in written:
        fail(f"the in-training demo wrote no {demo_wav}")
    demo = audio_io.read(demo_wav)[0]
    orig = audio_io.read(os.path.join(base, "inpainting", "original", "test_piece.wav"))[0]
    rec = audio_io.read(os.path.join(base, "inpainting", "reconstructed", "test_piece.wav"))[0]
    gap = np.flatnonzero(ta.prepare_mask()[0] == 0)
    hann = ta.sampler.hann_size
    far = np.ones(len(orig), bool)
    far[max(gap[0] - hann, 0):gap[-1] + 1 + hann] = False
    far_err = float(np.abs(rec[far] - orig[far]).max())
    audio_s = ta.audio_len / ta.fs
    rec_a = {"check": "testing", "loaded_latest_checkpoint": os.path.basename(latest),
             "weights_equal_checkpoint_ema": loaded, "inpainting_T35_s": ta.seconds["inpainting"],
             "inpainting_rtf": audio_s / ta.seconds["inpainting"], "main_a_wall_s": wall_a,
             f"seconds_per_mode_T{EVAL_T}": tb.seconds, "main_b_wall_s": wall_b, "demo_main_wall_s": wall_c,
             "denoiser_calls": got_calls, "expected_calls": expect_calls, "launches": launches,
             "launches_per_denoiser_call": per_fwd, "expected_launches": expected_launches,
             "wavs_written_finite": len(written),
             "metrics_files": scored, "observed_max_abs_err": far_err, "observed_tol": LSB,
             "gap_rms": float(np.sqrt(np.mean(rec[gap] ** 2))),
             "demo_rms": float(np.sqrt(np.mean(demo ** 2))), "card": card}
    log(json.dumps(rec_a))
    ok = (loaded and got_calls == expect_calls and launches == expected_launches
          and set(tb.seconds) == set(OTHER_MODES) and scored == 6 and far_err <= LSB
          and rec_a["gap_rms"] > 0 and rec_a["demo_rms"] > 0)
    if not ok:
        fail(f"evaluation path: {rec_a}")
    del ta, tb
    gc.collect()
    torch.cuda.empty_cache()
    plain = phase_testing_plain(torch, fa, np, corpus, work)
    return launches, {k: rec_a[k] for k in ("inpainting_T35_s", "inpainting_rtf",
                                            f"seconds_per_mode_T{EVAL_T}")} | plain


def phase_testing_plain(torch, fa, np, corpus, work):
    """8d: a reference-layout .pt from a seeded network loads back exactly;
    test_inpainting (T=EVAL_T, trained-like gates) with the kernel and with the
    plain version on the same noise."""
    from aid_tpu_torch import setup as tsetup
    from aid_tpu_torch.models.unet_cqt import MAIN_SCALE
    from aid_tpu_torch.utils.config import compose
    log("== phase 8d: a reference-layout .pt round trip; test_inpainting, kernel vs plain")
    d = os.path.join(work, "plain")
    os.makedirs(d, exist_ok=True)
    args = compose(overrides=eval_overrides(corpus, d, f"tester.T={EVAL_T}"))
    net = tsetup.setup_network(args, device="cuda", seed=0)
    net.init_weights(0, gate_scale=MAIN_SCALE)             # trained-like gates
    sd = {k: v.float().cpu() for k, v in net.state_dict().items()}
    path = os.path.join(d, "ref-1.pt")
    torch.save({"it": 1, "network": sd, "ema": sd, "optimizer": {}}, path)
    del sd
    diff = tsetup.setup_diff_parameters(args)
    tester = tsetup.setup_tester(args, network=tsetup.setup_network(args, device="cuda", seed=1),
                                 diff_params=diff, test_set=tsetup.setup_dataset_test(args))
    if not tester.load_checkpoint(path):
        fail("the reference-layout .pt did not load")
    own = net.state_dict()
    exact = all(torch.equal(v, own[k]) for k, v in tester.network.state_dict().items())
    del net, own
    out = {}
    for plain in (False, True):
        tester.gen.manual_seed(1234)
        saved = {}
        save = tester._save_triplet

        def spy(mode, name, original, degraded, reconstructed):
            saved[name] = np.asarray(reconstructed)
            save(mode, name, original, degraded, reconstructed)

        tester._save_triplet = spy
        with plain_forced(fa) if plain else contextlib.nullcontext():
            tester.test_inpainting(mode="inpainting_plain" if plain else "inpainting_kernel")
        tester._save_triplet = save
        out[plain] = saved["test_piece"]
    k, p = out[False], out[True]
    rel = float(np.abs(k - p).max() / np.abs(p).max())
    rec = {"check": "testing_kernel_vs_plain", "pt_round_trip_exact": exact, "T": EVAL_T,
           "rel_err": rel, "max_abs_err": float(np.abs(k - p).max()), "tol": BF16_TOL,
           "finite": bool(np.isfinite(k).all() and np.isfinite(p).all())}
    log(json.dumps(rec))
    if not (exact and rec["finite"] and rel <= BF16_TOL):
        fail(f"evaluation, kernel vs plain or .pt round trip: {rec}")
    del tester
    gc.collect()
    torch.cuda.empty_cache()
    return {"kernel_vs_plain_rel_err": rel}


# ------------------------------------------------------- user tools (10)

# steps of 10c-10g's samplers, cut from the configured 35 to keep the script
# within its time budget; 10a runs the learning gate's own T=25
TOOLS_T = 8
TOOLS_OV = [f"tester.T={TOOLS_T}"]


def load_script(path):
    """A script of the checkout (scripts/*_torch.py, the demo) as a module."""
    import importlib.util
    here = os.path.dirname(os.path.abspath(__file__))
    name = os.path.splitext(os.path.basename(path))[0]
    sys.path.insert(0, os.path.join(here, os.path.dirname(path)))
    spec = importlib.util.spec_from_file_location(name, os.path.join(here, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def finite(*xs):
    return all(math.isfinite(float(v)) for v in xs)


@contextlib.contextmanager
def counted(fa, into, key):
    """Kernel launches of a main-path run of phase 10 into ``into[key]``."""
    import torch
    torch.cuda.synchronize()
    fa.reset_launch_count()
    yield
    torch.cuda.synchronize()
    into[key] = fa.launch_count()


def phase_learning(torch, fa, np, work, card, launches):
    """10a: the learning gate at the JAX smoke's defaults, then the trained
    EMA sampled with the plain version, and the kernel at every tiny-net
    launch shape."""
    from aid_tpu_torch import setup as tsetup
    e2e = load_script("scripts/e2e_smoke_torch.py")
    cfg = e2e.config_from_env({"SMOKE_DTYPE": "bfloat16"})
    cfg["model_dir"] = os.path.join(work, "smoke")
    log(f"== phase 10a: the learning gate, scripts/e2e_smoke_torch.run: SMOKE_L {cfg['L']}, "
        f"{cfg['its']} steps at batch {e2e.BATCH} in f32 (TF32 convs, the training default), "
        f"sampling T=25 order 2 xi=0.25 in {cfg['dtype']}")
    torch.backends.cudnn.allow_tf32 = True       # as a user runs the script (README, TF32)
    try:
        with counted(fa, launches, "learning"):
            res = e2e.run(cfg, device="cuda")
    finally:
        torch.backends.cudnn.allow_tf32 = False
    dev = tsetup.resolve_device("cuda")
    with plain_forced(fa):
        fa.reset_launch_count()
        rec_plain = e2e.sample(res["args"], res["ediff"], res["ema"], res["y_masked"],
                               res["mask"], dev)
        plain_launches = fa.launch_count()
    rel_plain = float(np.abs(res["rec"] - rec_plain).max() / np.abs(rec_plain).max())
    net = tsetup.setup_network(res["args"], device=dev, state_dict=res["ema"])
    per_fwd = launches_per_forward(net)
    from aid_tpu_torch.diffusion import edm
    sigma = torch.full((1, 1), 0.5, device=dev)
    shapes = launch_shapes(torch, net, torch.zeros(1, cfg["L"], device=dev),
                           edm.cnoise(res["ediff"].params, sigma))
    gen = torch.Generator(device=dev).manual_seed(3)
    gelu = str(res["args"].network.gelu)
    err = max(check_launch_shapes(torch, fa, shapes, gelu, torch.float32, [e2e.BATCH], gen),
              check_launch_shapes(torch, fa, shapes, gelu, torch.bfloat16, [1], gen))
    scores = 2 * int(res["args"].tester.T) - 1
    expected = per_fwd * (res["its"] + 2 * scores)
    rec = {"check": "learning_gate", **{k: res[k] for k in (
        "its", "L", "dtype", "snr_untrained_db", "snr_trained_db", "snr_gain_db",
        "lsd_gap_trained", "lsd_gap_untrained", "lsd_gap_ratio", "s_per_it", "train_s",
        "sample_untrained_s", "sample_trained_s", "launches_per_train_step",
        "launches_per_sampling_run")},
           "gates": {"min_snr_gain_db": cfg["min_gain_db"], "max_lsd_ratio": cfg["max_lsd_ratio"]},
           "pass": res["ok"], "launches": launches["learning"], "expected_launches": expected,
           "plain_vs_kernel_rel_err": rel_plain, "plain_launches": plain_launches,
           "tol": BF16_TOL, "launch_shapes": {f"{r}x{c}": n for (r, c), n in sorted(shapes.items())},
           "launch_shapes_max_abs_err": err, "card": card}
    log(json.dumps(rec))
    if not (res["ok"] and rel_plain <= BF16_TOL and plain_launches == 0
            and launches["learning"] == expected and np.isfinite(rec_plain).all()):
        fail(f"the learning gate: {rec}")
    del net, res
    gc.collect()
    torch.cuda.empty_cache()
    return err, rec


def phase_tools(torch, fa, np, work, card):
    """Phase 10 in ``work``, after phase 8: phase 6e's model directory
    (``main``, its step-2 and step-4 checkpoints) is still there."""
    log("== phase 10: the port learns; the user tools on the card")
    t_phase = time.time()
    launches, out = {}, {}
    err, out["learning_gate"] = phase_learning(torch, fa, np, work, card, launches)
    md = os.path.join(work, "main")
    ck4 = os.path.join(md, "22k_8s-4.pt")
    per_fwd = FLAGSHIP_LAUNCHES
    scores = 2 * TOOLS_T - 1

    log("== phase 10b: scripts/make_synth_corpus_torch.py writes two 19 s test files")
    synth = os.path.join(work, "synth")
    load_script("scripts/make_synth_corpus_torch.py").write_corpus(synth, 0, 2, 19.0)

    log(f"== phase 10c: scripts/eval_checkpoints_torch.py on {md} (2 clips, EVAL_BATCH 2, "
        f"tester.T={TOOLS_T})")
    t0 = time.time()
    with counted(fa, launches, "eval_checkpoints"):
        ledger = load_script("scripts/eval_checkpoints_torch.py").run(
            md, synth, 2, TOOLS_OV, device="cuda", env={"EVAL_BATCH": "2"})
    rows = ledger["rows"]
    # the two checkpoints' EMA weights differ (two more steps of an EMA at
    # its ramp-up), so their rows come from two different networks
    from aid_tpu_torch.utils import checkpoint as ckpt
    ema2, ema4 = (ckpt.load(os.path.join(md, f"22k_8s-{i}.pt"))["ema"] for i in (2, 4))
    ema_diff = max(float((ema2[k].float() - ema4[k].float()).abs().max()) for k in ema2)
    out["eval_ledger"] = {"rows": rows, "masked_baseline": ledger["masked_baseline"],
                          "ema_max_abs_diff_it2_it4": ema_diff,
                          "row_diff_it2_it4": [abs(a - b) for a, b in zip(rows[0][1:], rows[1][1:])],
                          "wall_s": time.time() - t0}
    log(json.dumps({"check": "eval_checkpoints", **out["eval_ledger"]}))
    if not ([r[0] for r in rows] == [2, 4] and ledger["n_clips"] == 2 and ema_diff > 0
            and os.path.exists(os.path.join(md, "eval_ledger.json"))
            and all(finite(*r) for r in rows) and finite(*ledger["masked_baseline"].values())
            and launches["eval_checkpoints"] == per_fwd * scores * len(rows)):
        fail(f"eval_checkpoints: {ledger} launches {launches['eval_checkpoints']}")

    log(f"== phase 10d: scripts/eval_gap_sweep_torch.py on {ck4} (tester.T={TOOLS_T})")
    t0 = time.time()
    with counted(fa, launches, "eval_gap_sweep"):
        table = load_script("scripts/eval_gap_sweep_torch.py").run(ck4, synth, 2, TOOLS_OV,
                                                                    device="cuda")
    out["gap_sweep"] = {"rows": table["rows"], "wall_s": time.time() - t0}
    if not ([r[0] for r in table["rows"]] == [371, 743, 1486, 2962]
            and all(finite(*r) for r in table["rows"])
            and launches["eval_gap_sweep"] == per_fwd * scores * 4):
        fail(f"eval_gap_sweep: {table} launches {launches['eval_gap_sweep']}")

    out["demo"] = phase_demo(np, work, ck4)

    log(f"== phase 10f: scripts/serve_bench_torch.py, SERVE_REPS 1, the 22 kHz flagship "
        f"(tester.T={TOOLS_T})")
    with counted(fa, launches, "serve_bench"):
        bench = load_script("scripts/serve_bench_torch.py").run(overrides=TOOLS_OV, reps=1,
                                                                device="cuda")
    out["serve_bench"] = bench
    if not (len(bench) == 3 and all(finite(r["latency_s"], r["rtf"]) and r["card"] == card
                                    for r in bench) and launches["serve_bench"] > 0):
        fail(f"serve_bench: {bench}")

    out["export"] = phase_export(torch, fa, np, work, ck4, launches)
    out["launches"] = launches
    out["phase_s"] = time.time() - t_phase
    out["card"] = card
    log(json.dumps({"tools": out}))
    return sum(launches.values()), err


def phase_demo(np, work, ck4):
    """10e: examples/demo_inpainting_torch.py as a user runs it, in its own
    process: a 1500 ms time gap with phase 6e's step-4 checkpoint (observed
    samples of the written files bit-exact), then --spectrogram."""
    import subprocess
    from aid_tpu_torch.data import audio_io
    here = os.path.dirname(os.path.abspath(__file__))
    res = {}
    for mode, extra in (("time_gap", ["--checkpoint", ck4, "--gap-ms", "1500"]),
                        ("spectrogram", ["--spectrogram"])):
        d = os.path.join(work, f"demo_{mode}")
        cmd = [sys.executable, os.path.join(here, "examples", "demo_inpainting_torch.py"),
               "--T", str(TOOLS_T), "--out", d, *extra]
        log(f"== phase 10e: {' '.join(cmd[1:])}")
        t0 = time.time()
        p = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
        wall = time.time() - t0
        if p.returncode != 0:
            fail(f"the demo ({mode}) exited {p.returncode}:\n{p.stdout[-3000:]}\n{p.stderr[-3000:]}")
        sig = {n: audio_io.read(os.path.join(d, n + ".wav"))[0]
               for n in ("original", "degraded", "reconstructed")}
        rec = {"wall_s": wall, "finite": all(bool(np.isfinite(v).all()) for v in sig.values()),
               "samples": len(sig["reconstructed"])}
        if mode == "time_gap":
            L, fs, hann = len(sig["original"]), 22050, 50
            gap = int(1.5 * fs)
            s = (L - gap) // 2
            far = np.ones(L, bool)
            far[s - hann:s + gap + hann] = False
            rec["observed_bit_exact"] = bool(np.array_equal(sig["reconstructed"][far],
                                                            sig["original"][far]))
            rec["gap_rms"] = float(np.sqrt(np.mean(sig["reconstructed"][s:s + gap] ** 2)))
        res[mode] = rec
        log(json.dumps({"check": "demo", "mode": mode, **rec}))
        if not (rec["finite"] and rec.get("observed_bit_exact", True)
                and rec.get("gap_rms", 1.0) > 0):
            fail(f"the demo ({mode}): {rec}")
    return res


def phase_export(torch, fa, np, work, ck4, launches):
    """10g: export_checkpoint_from on phase 6e's step-4 checkpoint; the
    reference .pt loads back bit-equal; parity_vs_reference_torch exports
    its f32 denoiser and compares against its own export."""
    from aid_tpu_torch import setup as tsetup
    from aid_tpu_torch.utils import checkpoint as ckpt
    from aid_tpu_torch.utils import checkpoint_torch
    from aid_tpu_torch.utils.config import compose
    log(f"== phase 10g: export_checkpoint_from({os.path.basename(ck4)}), the reference .pt "
        "loaded back, parity_vs_reference_torch --export, then --compare")
    ref = os.path.join(work, "ref-4.pt")
    checkpoint_torch.export_checkpoint_from(ck4, ref)
    ema = ckpt.load(ck4)["ema"]
    net = tsetup.setup_network(compose(overrides=[*TOOLS_OV, "network.compute_dtype=float32"]),
                               device="cuda", seed=1)
    checkpoint_torch.load_reference_checkpoint(ref, net)
    exact = all(torch.equal(v.cpu(), ema[k].float()) for k, v in net.state_dict().items())
    del net, ema
    gc.collect()
    torch.cuda.empty_cache()
    parity = load_script("scripts/parity_vs_reference_torch.py")
    npz = os.path.join(work, "parity.npz")
    with counted(fa, launches, "parity"):
        got = parity.run(parity.parse(["--pt", ref, "--export", npz]), TOOLS_OV)
    same = parity.run(parity.parse(["--pt", ref, "--compare", npz]), TOOLS_OV)
    rec = {"check": "export", "pt_round_trip_bit_equal": exact,
           "denoised_finite": bool(np.isfinite(got["denoised"]).all()),
           "compare_max_abs_diff": same["max_abs_diff"], "compare_tol": parity.COMPARE_TOL,
           "launches": launches["parity"]}
    log(json.dumps(rec))
    if not (exact and rec["denoised_finite"]
            and launches["parity"] == FLAGSHIP_LAUNCHES * len(parity.SIGMAS)):
        fail(f"export and parity: {rec}")
    return rec


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

    phase_options(torch, fa, card)
    launches, rtf, answers = phase_serving(torch, fa, np, batches)
    request_b = answers["b_four_25ms_gaps"]
    log(json.dumps({"inpaint_rtf_request_a": rtf, "card": card}))
    work = os.path.join(here, "experiments", "chip_smoke_training")
    shutil.rmtree(work, ignore_errors=True)
    try:
        os.makedirs(work)
        launches_44k, timing_44k, serving_44k = phase_serving_44k(torch, fa, np, work, card)
        log(json.dumps({"serving_44k": serving_44k, "card": card}))
        train_launches, train_err = phase_training(torch, fa, np, work, card, shapes)
        parallel_launches, parallel_err = phase_parallel(
            torch, fa, np, work, card, answers["a_centre_gap_1500ms"], request_b)
        test_launches, testing = phase_testing(torch, fa, np, work, card)
        tools_launches, tools_err = phase_tools(torch, fa, np, work, card)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(json.dumps({"testing": {**testing, "card": card}}))
    log(json.dumps({"launches_by_path": {"serving": launches, "serving_44k": launches_44k,
                                         "training": train_launches,
                                         "parallel": parallel_launches,
                                         "testing": test_launches,
                                         "tools": tools_launches}}))

    log("== phase 9: kernels")
    kernels = [{"name": "fused_adaln_fwd", "route": "triton",
                "source": "aid_tpu_torch/ops/fused_adaln.py",
                "replaces": "aid_tpu/ops/pallas/fused_adaln.py:62",
                "launches": (launches + launches_44k + train_launches + parallel_launches
                             + test_launches + tools_launches),
                "max_abs_err": max(worst[("bfloat16", "tanh")], timing["max_abs_err"],
                                   timing_44k["max_abs_err"], train_err, parallel_err,
                                   tools_err),
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
    if len(sys.argv) == 4 and sys.argv[1] == "--rank":   # a rank of phase 7
        rank_main(int(sys.argv[2]), sys.argv[3])
    else:
        main()
