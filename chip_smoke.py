#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py
    python3 chip_smoke.py --diffwave      # phases 1 and 12 alone

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
     order 2, guided) precompiles its guided-Heun programs (CUDA graphs, one
     per row count up to max_batch: capture time, memory_bytes, launches per
     run) and answers 3 requests through them: an 8.35 s clip with a 1500 ms
     centre gap, ~2.5 windows with four 25 ms gaps, and a clip whose gap
     exceeds 0.6 windows (chained); launch counts (those the graphs' replays
     make) and the real-time factor; (d) request (a)'s round against
     heun_sample run eagerly on the same noise (bf16 tolerance; wall time and
     peak memory beside the program's), and against the program built with
     the plain version patched in;
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
     bit-exact), all through the programs; (d) the request's round against
     heun_sample run eagerly on the same noise; the resampler route and the
     native library's build status;
  6. training (the second main path) on a synthetic corpus in MAESTRO v3
     layout (CSV + WAVs at 44.1 and 48 kHz, longer than load_len), full
     flagship width, batch 4, f32:
       a. the kernel against its plain version at batch 4, f32, tanh, at the
          largest launch shapes: forward and the autograd.Function's dx,
          dinv and dmod; then at every launch shape, timed at batch 4 f32
          over one training forward as in phase 4;
       b. one training step with the plain version (eagerly) and one with
          the kernel (replayed from the step program that b' builds)
          (mixed-rate batch, TF32 off): loss and pre-clip gradient norm;
          the first step leaves the parameters as they were (lr 0);
       b'. ``compile_step`` leaves the state, ``it`` and the random stream
          as they were; from one state, the eager step, the captured step
          (replayed) and the eager step again on the same batch and draws:
          the loss, the update's relative L2 distance from the first eager
          step's beside the second eager step's, the walls, the program's
          ``memory_bytes()`` and launches;
       c. the gradients with remat "block" and "conv" against no remat,
          with the peak memory of each;
       d. four steps, a checkpoint at step 2, a fresh trainer resumed from
          it takes steps 3 and 4 on the same batches and draws, and ends
          where the uninterrupted trainer ended;
       e. the entry point: aid_tpu_torch.train.main runs 4 steps from the
          corpus (remat on, TF32 as the training default), checkpoints at 2
          and 4; a second main resumes from the step-2 checkpoint and
          reaches step 4; step time, peak memory and launches per step (the
          steps replay the step program each main builds at its first step);
  7. multi-device (the port's torch.distributed path), full flagship width;
     while the ranks run 7c-7g (the last rank also 7c's one-rank
     reference), this process runs 7b's one-rank reference, 7a and 8a-8b;
     the ranks' training steps (7b), whose
     programs' pools take most of the card, run after that, beside 10a
     (light on device memory); the card's least free memory over the phase
     is printed:
       a. ``aid_tpu_torch.train.main`` with exp.mesh.fsdp over NCCL, one rank
          (the card count), 2 steps, TF32 as the training default, replayed
          from the captured FSDP step (``compile_step`` before the first:
          state, ``it`` and random stream unchanged); after step 2 the
          replayed step against the eager step (loss, the update's distance
          beside two eager steps', walls); launches, ``memory_bytes()``,
          peak memory, the checkpoint in the one-device layout;
       b. two ranks sharing the card over gloo (this script again, with
          ``--rank R DIR``), each holding the kernel against its plain
          version: 2 DDP steps replayed from the dp step program (two graphs
          around the gradient all-reduce, which runs eagerly between them),
          its update within the spread of two eager DDP steps, and 2 FSDP
          steps (eager: a capture holds NCCL's collectives only), at global
          batch 4, f32, TF32 off, against the one-rank trainer's steps on
          the same batch and draws (loss, pre-clip norm, parameters); step
          time against the eager step, ``memory_bytes()`` and peak memory
          per rank;
       c. ``InpaintingService.shard()`` over dp=2 answers phase 5's request
          (b) (2 rows a round, one per rank, each through its rank's
          program) at tester.T=8 (cut from 35 for the time budget): within
          phase 3's bf16 tolerance of the one-rank service's answer at the
          same settings, observed samples bit-exact, equal to the same
          request answered eagerly on each rank (max difference 0), RTF
          through the programs and eagerly;
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
       d-g run eagerly (their collectives sit inside every score; a graph
       holds only NCCL's, which needs a card a rank) and say so; every
       rank's launches go into the kernels line;
  8. evaluation (the third main path; a-b beside phase 7's ranks, so their
     walls are taken on a shared card) at full flagship width, bf16, on the
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
          launches over a-c equal to 90 per denoiser evaluation (each
          program's warm-up and replays counted, its capture not) plus 180
          per training step; the memory the demo's program holds;
       d. a reference-layout ``.pt`` written from a seeded network loads back
          exactly, and ``test_inpainting`` with the plain version patched in
          agrees with the kernel run within phase 3's bf16 tolerance;
       e. spectrogram inpainting, bandwidth extension, declipping, phase
          retrieval, compressive sensing and ``rid`` inpainting, each through
          its program at full width, one row, T=4 (seeded weights), under
          cuDNN's deterministic switch, against the same task run eagerly on
          the same noise (x and every Record field bit for bit; a second
          run replays the same program, its launches read from the
          counter, and agrees bit for bit as well): the difference, capture
          time, walls,
          ``memory_bytes()`` and launches of each; the BWE program built
          with the plain version against its kernel program;
  10. the port learns (a: beside phase 7's ranks), and the user tools (b-g:
     after 8d, in its work directory), bf16 serving at full flagship width
     unless said:
       a. the learning gate: ``scripts/e2e_smoke_torch.run`` trains the tiny
          CQTDiff+ on synthetic chords (SMOKE_L 16384, 400 steps at batch 8,
          f32 with TF32 convs, every step replayed from the trainer's step
          program) and inpaints a 50 ms gap with its EMA before
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
          samples bit-exact; started with phase 7's ranks, beside them),
          and with ``--spectrogram`` in another (started after phase 7,
          beside 8c-8d and 10b-10d); both are checked here;
       f. ``scripts/serve_bench_torch.py`` with SERVE_REPS 1: its three
          rows with the card;
       g. ``export_checkpoint_from`` on the step-4 checkpoint: the reference
          ``.pt`` loads back bit-equal; ``parity_vs_reference_torch``
          exports its f32 denoiser (finite) and passes against itself;
       h. ``NPROC=2 scripts/training_torch.sh`` (torch.distributed.run, two
          ranks sharing the card over gloo) trains 2 steps at exp.batch 2 on
          phase 6e's corpus: exit 0, rank 0 writes 22k_8s-2.pt, every
          ``it N loss`` line finite, scripts/train_report_torch.py reads them;
       i. ``scripts/testing_torch.sh`` with CKPT empty in 10h's MODEL_DIR
          (the latest-checkpoint scan loads 10h's checkpoint): no "no
          checkpoint found", every wav and metrics.json finite, observed
          samples within one 16-bit step farther than ``hann_size`` from the
          gap, the gap non-zero; the mode's seconds and RTF;
       j. ``scripts/testing_shortgaps_torch.sh`` with CKPT a reference
          ``.pt`` of the 44.1 kHz flagship on phase 5b's seeded weights, on
          two 44.1 kHz files with a ``.npy`` mask each (four 25 ms gaps):
          the same checks;
     10h-10j run the launchers as a user runs them, one process after
     another, in a thread of this script beside 8c-8d and 10b-10g; their
     kernel launches happen in their own processes and are not counted in
     the kernels line; 10c-10j run tester.T=8 (cut from 35, and 70 for the
     short gaps, for the time budget);
  11. the measuring entry points, each a process of its own as a user runs
     it; their kernel launches happen in those processes and are not
     counted in the kernels line:
       a. alone on the card, after 10h-10j's join: ``python bench_torch.py``
          with BENCH_SUITE=headline, BENCH_REPS=1 (the 22 kHz flagship,
          bf16, BENCH_BATCH 2, T=35: a finite RTF, 69 denoiser calls a
          trajectory as counted, 2 rows, a finite output), then with
          BENCH_SUITE=full at tester.T=4 (cut from 35 and 70: the plumbing
          of every leg): shortgaps_rtf, uncond_rtf and rtf_44k present and
          positive, no ``*_error``;
       b. beside 8c-8d and 10b-10g, after 10j: BENCH_DEVICES=2 under
          torch.distributed.run (two ranks sharing the card over gloo,
          headline at T=4: arithmetic, not scaling): one result line with
          ``"devices": 2``;
       c. alone on the card, after 11a: ``TRAIN_BENCH_STEPS=3
          scripts/bench_train_torch.py`` at the flagship (batch 4, f32,
          remat, TF32 convs as the training default): a finite ms a step;
       d. host only, beside 11a and 11c: ``scripts/bench_loader_torch.py
          --files 4 --secs 30 --batches 10``: its three ``num_workers=`` rows;
  12. DiffWave (network=diffwave_16k, exp=librispeech16k_8s), after 11:
       a. the gate kernels (``ops/gated_tanh.py``) against their plain
          version at the served shape [2, 512, 131072], bf16 and f32,
          forward and backward;
       b. their device time per 2-row guided score (36 launches each way)
          against the plain version's and the bytes bound, inputs not in L2;
       c. the dilated conv C -> 2C at every dilation, cuDNN's dilated
          conv1d against the folded form: at [2, 256, 131072] bf16, forward
          and with the input gradient; at [4, 256, 131072] f32 (TF32),
          forward and with both gradients; the 1x1 conv as conv1d and as
          matmul;
       d. one guided score at [2, 131072]: the bf16 net against the f32
          reference (``tests/diffwave_reference.py``, TF32 off) on the same
          weights, device time and peak memory of each, 36 gate launches
          each way;
       e. a captured f32 training step at batch 4 with remat (TF32 convs):
          build, step time, peak memory (no benchmark cell trains DiffWave),
          in the net's conv forms and again with every f32 conv from d = 16
          folded;
       f. ``InpaintingService.from_config`` serves a 20 s request with two
          gaps through its programs under the profiler: observed samples
          exact, ``_gated_tanh_fwd`` and ``_gated_tanh_bwd`` in the trace,
          their counters non-zero;
  9. each phase's seconds, the ``kernels`` JSON line (phase 10's launches
     and errors included), then the device JSON line.

f32 comparisons run with TF32 off (torch.backends.cuda.matmul.allow_tf32
and torch.backends.cudnn.allow_tf32 both False).
"""
import contextlib
import gc
import json
import math
import os
import re
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


PHASE_S = {}               # wall seconds of each phase of main()


def log(*a):
    # one write a line: 10h-10j's checks log from a thread of their own
    sys.stdout.write(" ".join(map(str, a)) + "\n")
    sys.stdout.flush()


@contextlib.contextmanager
def killed_on_failure(procs):
    """Kill the processes ``procs`` if the body raises (a failed check
    exits through SystemExit), so none outlives the script."""
    procs = list(procs)
    try:
        yield
    except BaseException:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        raise


@contextlib.contextmanager
def phase_time(name):
    """Times a phase of main(); logs its seconds and, as it ends, this
    process's allocated and reserved device memory and the card's use."""
    import torch
    t0 = time.time()
    try:
        yield
    finally:
        PHASE_S[name] = time.time() - t0
        free, total = torch.cuda.mem_get_info()
        log(json.dumps({"phase": name, "seconds": PHASE_S[name],
                        "allocated_gb": torch.cuda.memory_allocated() / 2 ** 30,
                        "reserved_gb": torch.cuda.memory_reserved() / 2 ** 30,
                        "card_used_gb": (total - free) / 2 ** 30, **pinned(torch)}))


def pinned(torch):
    """What keeps this process's reserved memory after ``empty_cache``: the
    segments that hold a live block (their sizes, the bytes live in the
    five largest), the CUDA graphs that only a reference cycle kept alive
    (freed by the collection here; programs are meant to be freed by
    reference counting), and the graphs still alive."""
    def graphs():
        return sum(isinstance(o, torch.cuda.CUDAGraph) for o in gc.get_objects())

    before = graphs()
    gc.collect()
    alive = graphs()
    torch.cuda.empty_cache()
    segs = [(s["total_size"], s["allocated_size"], s.get("segment_pool_id"))
            for s in torch.cuda.memory.memory_snapshot() if s["allocated_size"] > 0]
    segs.sort(key=lambda t: -t[0])
    return {"pinned_segments": len(segs), "pinned_gb": sum(t[0] for t in segs) / 2 ** 30,
            "largest_pinned_mb": [[t[0] / 2 ** 20, t[1] / 2 ** 20, str(t[2])]
                                  for t in segs[:5]],
            "graphs_in_cycles": before - alive, "graphs_alive": alive}


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


@contextlib.contextmanager
def built_programs():
    """The report of every sampler program (``sampling.program.HeunProgram``)
    captured inside, taken when its build ends (a program itself is not
    kept: it holds its graph pool). Each one's warm-up ran its two steps
    once, eagerly, so it evaluated the denoiser ``warmup_scores`` times on
    the device."""
    from aid_tpu_torch.sampling import program
    orig, built = program.HeunProgram.__init__, []

    def init(self, *a, **k):
        orig(self, *a, **k)
        if self.graphs is not None:      # captured (``report()`` needs the build's seconds)
            built.append(self.report())

    program.HeunProgram.__init__ = init
    try:
        yield built
    finally:
        program.HeunProgram.__init__ = orig


def warmup_scores(built):
    return sum(r["scores"]["body"] + r["scores"]["last"] for r in built)


def program_reports(sampler):
    return [p.report() for p in sampler._programs.values()]


def program_vs_eager(torch, fa, np, svc, call, card, tag):
    """One served round (``call`` = (xb, mb, seed, answer) of ``_run_batch``,
    answered by the sampler's program) against ``heun_sample`` run eagerly
    on the same inputs and the same noise (the generator seeded as the
    round seeded it), with the eager trajectory's wall time and peak
    memory beside the program's ``memory_bytes()``."""
    from aid_tpu_torch.sampling import degradations as degr
    from aid_tpu_torch.sampling import heun
    xb, mb, seed, got = call
    s, dev = svc.sampler, svc.device
    y = torch.from_numpy((xb * mb).astype(np.float32)).to(dev)
    m = torch.from_numpy(mb.astype(np.float32)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    prior, churn = heun.draw_noise(tuple(y.shape), s.cfg.T, gen, dev)
    smooth = s._smooth_mask(m)
    proj = degr.inpainting_projector(y, smooth)
    score = heun.make_score_fn(s.p, s.cfg, s._denoise, y=y, degradation=degr.time_mask(m),
                               proj=proj, hpf=s._hpf())
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    eager = heun.heun_sample(tuple(y.shape), s.p, s.cfg, score, proj_end=proj, prior=prior,
                             churn=churn)
    torch.cuda.synchronize()
    eager_s = time.time() - t0
    peak = torch.cuda.max_memory_allocated() - base
    eager = eager.float().cpu().numpy()
    prog = svc._compiled_for_batch(len(xb))
    rec = {"check": "program_vs_eager", "request": tag, "rows": len(xb),
           "max_abs_diff": float(np.abs(got - eager).max()),
           "rel_err": float(np.abs(got - eager).max() / np.abs(eager).max()), "tol": BF16_TOL,
           "finite": bool(np.isfinite(got).all() and np.isfinite(eager).all()),
           "eager_trajectory_s": eager_s, "eager_peak_bytes": peak,
           "program": prog.report(), "card": card}
    log(json.dumps(rec))
    if not (rec["finite"] and rec["rel_err"] <= BF16_TOL and prog.graphs is not None):
        fail(f"the program disagrees with the eager sampler: {rec}")
    return rec, (y, m, smooth, prior, churn)


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


def bwd_errors(torch, fa, x, g, inv, mod, gelu):
    """The backward kernel and the plain backward against the same formula
    in float64, on x, g [B, R, C]: for each, the largest |dx - exact| over
    (one ulp of x's dtype at |exact|, plus an f32 ulp of |g s|) -- at most
    1 is within tolerance -- and the largest row-sum error over the sum of
    |dv x| (``q_err``). The plain backward's f32 tanh tail cancels (1 + th
    and 1 - th^2 near th = -1), so the exact value is the yardstick."""
    s = (inv.double() * mod.double())[:, None, :]
    xd = x.double()
    dv = g.double() * fa._gelu_grad(xd * s, gelu)
    dx64, q64, scale = dv * s, (dv * xd).sum(1), (dv * xd).abs().sum(1)
    ulp = 2.0 ** -7 if x.dtype == torch.bfloat16 else 2.0 ** -23
    floor = (g.double() * s).abs() * 2.0 ** -23
    out = {}
    for name, fn in (("kernel", fa._fused_bwd_cuda), ("plain", fa.fused_bwd_plain)):
        dx, q = fn(x, g, inv, mod, gelu)
        out[f"{name}_dx_ulps"] = ((dx.double() - dx64).abs()
                                  / (ulp * dx64.abs() + floor + 1e-300)).max().item()
        out[f"{name}_q_err"] = ((q.double() - q64).abs() / (scale + 1e-300)).max().item()
    return out


def time_kernel_bwd(torch, fa, shapes, gelu, dt, time_batch=1):
    """The backward kernel at every launch shape at batch ``time_batch``:
    checked against the float64 formula beside the plain backward
    (``bwd_errors``), then kernel and plain device time summed over one
    differentiated forward's launches, beside the bytes bound (x and g read,
    dx written once). Inputs not in L2, as ``time_kernel``."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    ms = plain_ms = bytes_ = 0.0
    errs = {}
    B = time_batch
    for (R, C), n in sorted(shapes.items()):
        inv = torch.rand(B, C, generator=gen, device="cuda") + 0.5
        mod = torch.rand(B, C, generator=gen, device="cuda") + 0.5
        step = 3 * B * R * C * torch.finfo(dt).bits // 8   # two reads, one write

        def draw():
            return torch.randn((B, R, C), generator=gen, device="cuda").to(dt)

        for k, v in bwd_errors(torch, fa, draw(), draw(), inv, mod, gelu).items():
            errs[k] = max(errs.get(k, 0.0), v)
        sets = [(draw(), draw(), inv, mod, gelu)
                for _ in range(max(2, math.ceil(3 * l2 / (step * 2 // 3))))]
        with torch.no_grad():
            k = graph_ms(torch, fa._fused_bwd_cuda, sets)
            p = graph_ms(torch, fa.fused_bwd_plain, sets[:2], reps=4)
        del sets
        log(json.dumps({"timing": "fused_adaln_bwd launch", "shape": [B, R, C],
                        "launches": n, "ms": k, "plain_ms": p,
                        "bytes_bound_ms": step / HBM_BYTES_PER_S * 1e3}))
        ms += n * k
        plain_ms += n * p
        bytes_ += n * step
    torch.cuda.empty_cache()
    # one bf16 ulp; in f32 libdevice's erf and the approximate exp and
    # divide leave a few ulps (tests/test_torch_cuda.py's DX_F32_ULPS)
    if errs["kernel_dx_ulps"] > (1.0 if dt == torch.bfloat16 else 4.0) \
            or errs["kernel_q_err"] > 1e-5:
        fail(f"backward kernel off the float64 formula: {errs}")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bytes_ / HBM_BYTES_PER_S * 1e3,
                bound_by="bytes", bytes=bytes_, launches=sum(shapes.values()), **errs)


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
            out[fused] = (d, s, n_fwd, fa.launch_count(), fa.bwd_launch_count())
    (d, s, n_fwd, n_score, n_bwd), (dp, sp, n0, n1, nb0) = out[True], out[False]
    d_err = ((d - dp).abs().max() / dp.abs().max()).item()
    s_err = ((s - sp).abs().max() / sp.abs().max()).item()
    rec = {"check": "denoiser", **tags, "batch": audio.shape[0],
           "launches_per_forward": n_fwd, "launches_per_guided_score": n_score,
           "bwd_launches_per_guided_score": n_bwd,
           "plain_launches": n0 + n1 + nb0, "denoiser_rel_err": d_err,
           "guided_score_rel_err": s_err, "tol": tol,
           "finite": bool(torch.isfinite(d).all() and torch.isfinite(s).all())}
    log(json.dumps(rec))
    if n_fwd != expected or n_score != expected or n_bwd != expected or n0 + n1 + nb0 != 0:
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


def phase_serving(torch, fa, np, batches, card):
    log("== phase 5: InpaintingService.from_config([]) answers 3 requests through its "
        "precompiled programs (CUDA graphs)")
    from aid_tpu_torch.models.unet_cqt import MAIN_SCALE
    from aid_tpu_torch.serving import InpaintingService
    t0 = time.time()
    svc = InpaintingService.from_config([])
    svc.network.init_weights(0, gate_scale=MAIN_SCALE)   # trained-like gates
    L, fs = int(svc.args.exp.audio_len), int(svc.args.exp.sample_rate)
    T, order = svc.sampler.cfg.T, svc.sampler.cfg.order
    log(f"service built in {time.time() - t0:.1f} s: L={L} fs={fs} T={T} order={order} "
        f"max_batch={svc.max_batch} dtype={svc.network.dtype}")
    t0 = time.time()
    svc.precompile()
    log(json.dumps({"check": "precompile", "wall_s": time.time() - t0,
                    "programs": program_reports(svc.sampler), "card": card}))
    rounds, calls = [], []
    run = svc._run_batch

    def counted(xb, mb, seed):
        rounds.append(xb.shape[0])
        t1 = time.time()
        out = run(xb, mb, seed)
        calls.append((xb, mb, seed, out, time.time() - t1))
        return out

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
    with built_programs() as built:
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
                   "rounds": rounds[r0:], "round_s": [c[4] for c in calls[r0:]],
                   "wall_s": wall, "rtf": n / fs / wall,
                   "finite": bool(np.isfinite(out).all()),
                   "observed_exact": bool(np.array_equal(out[~gap], audio[~gap])),
                   "gap_nonzero": bool(np.abs(out[gap]).max() > 0),
                   "gap_rms": float(np.sqrt(np.mean(out[gap] ** 2)))}
            log(json.dumps(rec))
            results.append(rec)
        torch.cuda.synchronize()
        launches = fa.launch_count()     # ... and ends here
    expected = 90 * steps_per_traj * len(rounds)
    log(json.dumps({"check": "serving_launches", "launches": launches,
                    "expected": expected, "rounds": len(rounds),
                    "score_calls_per_round": steps_per_traj, "programs_built_in_path": len(built),
                    "programs": program_reports(svc.sampler)}))
    for rec in results:
        if not (rec["finite"] and rec["observed_exact"] and rec["gap_nonzero"]):
            fail(f"bad inpainting output: {rec}")
    if launches != expected or built:
        fail(f"kernel launches {launches} != {expected} or programs built in the path "
             f"({len(built)}): the path skipped the kernel or the precompiled programs")
    if not set(rounds) <= set(batches):
        fail(f"rounds of {sorted(set(rounds))} rows; the kernel was checked at {batches}")

    log("== phase 5(d): request (a)'s round: the program against heun_sample run eagerly on "
        "the same noise; the program built with the plain version against the kernel's")
    cmp, (y, m, smooth, prior, churn) = program_vs_eager(
        torch, fa, np, svc, calls[0][:4], card, "a_centre_gap_1500ms")
    cmp["observed_exact"] = results[0]["observed_exact"]
    cmp["eager_rtf"] = results[0]["seconds_of_audio"] / cmp["eager_trajectory_s"]
    cmp["program_rtf"] = results[0]["rtf"]
    kernel_prog = svc._compiled_for_batch(1)
    with plain_forced(fa):
        n0 = fa.launch_count()
        plain_prog = svc.sampler.compile_inpainting(y, m)
        plain = plain_prog.run(prior, churn, y=y, mask=m, smooth=smooth).float().cpu().numpy()
        torch.cuda.synchronize()
        plain_launches = fa.launch_count() - n0
    got = calls[0][3]
    rec = {"check": "program_kernel_vs_plain", "request": "a_centre_gap_1500ms",
           "rel_err": float(np.abs(got - plain).max() / np.abs(plain).max()), "tol": BF16_TOL,
           "plain_launches": plain_launches, "plain_program": plain_prog.report(),
           "card": card}
    log(json.dumps(rec))
    if not (plain_prog is not kernel_prog and plain_launches == 0
            and plain_prog.launches_per_run() == 0 and rec["rel_err"] <= BF16_TOL
            and cmp["observed_exact"] and np.isfinite(plain).all()):
        fail(f"the plain-version program: {rec}")
    del svc._run_batch   # no cycle: freed by reference counting
    del svc
    gc.collect()
    torch.cuda.empty_cache()
    return launches, results[0]["rtf"], answers, {"program_vs_eager": cmp,
                                                   "kernel_vs_plain_rel_err": rec["rel_err"]}


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
    timing_bwd = time_kernel_bwd(torch, fa, shapes, "tanh", torch.bfloat16)
    log(json.dumps({"timing": "fused_adaln_bwd per 44 kHz guided score", **timing_bwd,
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
                    "max_batch": svc.max_batch, "programs": program_reports(svc.sampler),
                    "card": card}))

    rounds, calls, run = [], [], svc._run_batch

    def counted(xb, mb, seed):
        rounds.append(xb.shape[0])
        t1 = time.time()
        out = run(xb, mb, seed)
        calls.append((xb, mb, seed, out, time.time() - t1))
        return out

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
    with built_programs() as built:
        fa.reset_launch_count()          # the 44 kHz serving path starts here
        t0 = time.time()
        svc.inpaint_file(src, m48, dst, seed=1)
        wall_file = time.time() - t0
        rounds_file = list(rounds)
        out_file = results["out"]
        t0 = time.time()
        out44 = svc.inpaint(a44, m44, fs, seed=2)
        wall44 = time.time() - t0
        torch.cuda.synchronize()
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
             "rounds": rounds[len(rounds_file):],
             "round_s": [c[4] for c in calls[len(rounds_file):]],
             "wall_s": wall44, "rtf": n44 / fs / wall44,
             "finite": bool(np.isfinite(out44).all()),
             "observed_exact": bool(np.array_equal(out44[~gap44], a44[~gap44])),
             "gap_nonzero": bool(np.abs(out44[gap44]).max() > 0),
             "gap_rms": float(np.sqrt(np.mean(out44[gap44] ** 2)))}
    expected = LAUNCHES_44K * steps * len(rounds)
    for r in (rec_file, rec44):
        log(json.dumps({**r, "card": card}))
    log(json.dumps({"check": "serving_44k_launches", "launches": launches, "expected": expected,
                    "rounds": len(rounds), "score_calls_per_round": steps,
                    "programs_built_in_path": len(built),
                    "programs": program_reports(svc.sampler)}))
    ok = (rate_in == rate_out == fs48 and len(x_out) == len(x_in) == n48
          and rec_file["finite"] and rec_file["observed_exact_in_memory"]
          and rec_file["far_max_abs_err_in_file"] <= LSB and rec_file["gap_nonzero"]
          and rec44["finite"] and rec44["observed_exact"] and rec44["gap_nonzero"]
          and set(rounds) == {1} and launches == expected and not built)
    if not ok:
        fail(f"44 kHz serving: {rec_file} {rec44} launches {launches} != {expected}, "
             f"programs built in the path {len(built)}?")
    log("== phase 5b(d): the 44.1 kHz request's round: the program against heun_sample run "
        "eagerly on the same noise")
    cmp, _ = program_vs_eager(torch, fa, np, svc, calls[-1][:4], card, "a44_centre_gap_1500ms")
    cmp["observed_exact"] = rec44["observed_exact"]
    cmp["eager_rtf"] = rec44["seconds_of_audio"] / cmp["eager_trajectory_s"]
    cmp["program_rtf"] = rec44["rtf"]
    del svc._footprint, svc._run_batch, svc.inpaint   # no cycle: freed by reference counting
    del svc
    gc.collect()
    torch.cuda.empty_cache()
    return launches, timing, {"rtf_file_48k": rec_file["rtf"], "rtf_44k_request": rec44["rtf"],
                              "autotune_fit": fit, "program_vs_eager": cmp}


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
        "mixed 44.1/48 kHz batch): the plain version's step eagerly, the kernel's through "
        "the step program compile_step builds (6b')")
    p0 = [p.detach().clone() for p in tr.params]
    with plain_forced(fa):
        tr.init_state()
        torch.cuda.synchronize()
        fa.reset_launch_count()
        m = tr._train_step(audio, fs, draws[0], program=False)
        lp, gp, n_plain = float(m["loss"]), float(m["grad_norm"]), fa.launch_count()
    if not all(torch.equal(a, b) for a, b in zip(tr.params, p0)):
        fail("the first training step moved the parameters (lr must be 0)")
    program, step1 = phase_train_program(torch, fa, np, tr, batches, draws, per_fwd, card)
    lk, gk, nk = step1["loss"], step1["grad_norm"], step1["launches"]
    rec = {"check": "train_step", "loss": lk, "plain_loss": lp, "grad_norm": gk,
           "plain_grad_norm": gp, "loss_rel_err": abs(lk - lp) / abs(lp),
           "grad_norm_rel_err": abs(gk - gp) / abs(gp), "tol": 1e-4,
           "launches": nk, "plain_launches": n_plain,
           "params_unchanged_after_step_1": step1["params_unchanged"]}
    log(json.dumps(rec))
    if not (math.isfinite(lk) and math.isfinite(gk) and rec["loss_rel_err"] <= 1e-4
            and rec["grad_norm_rel_err"] <= 1e-4):
        fail(f"training step, kernel vs plain: {rec}")
    if not step1["params_unchanged"]:
        fail("the first training step moved the parameters (lr must be 0)")
    # the replayed step launches what its capture recorded (compile_step's
    # warm-up launched as many)
    if nk != 2 * per_fwd or n_plain != 0:
        fail(f"expected {2 * per_fwd} kernel launches in a replayed remat training step: "
             f"{rec}")

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
            "launches_per_step": 2 * per_fwd, "launches_per_forward": per_fwd,
            "program": program}


def phase_train_program(torch, fa, np, tr, batches, draws, per_fwd, card):
    """6b': ``compile_step`` leaves the state, ``it`` and the random stream
    as they were; step 1 replays the program (6b's kernel step); from step
    1's state, the captured step (replayed once) against the eager step
    (run before and after it) on the same batch and draws: the loss and the
    update's relative L2 distance from the first eager step's, beside the
    second eager step's;
    walls, the program's memory and launches. Returns its summary and step
    1's loss, norm, launches and whether it left the parameters."""
    log("== phase 6b': the captured training step against the eager step (TF32 off)")
    (a0, f0), d0 = batches[0], draws[0]
    (a1, f1), d1 = batches[1], draws[1]
    tr.init_state()
    prog, compile_s, unchanged = compile_checked(torch, tr, a0, f0)
    p0 = [p.detach().clone() for p in tr.params]
    torch.cuda.synchronize()
    fa.reset_launch_count()
    m = tr.train_step(a0, f0, d0)                # step 1 (lr 0), replayed
    step1 = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
             "launches": fa.launch_count(),
             "params_unchanged": all(torch.equal(a, b) for a, b in zip(tr.params, p0))}
    del p0
    cmp, within = replay_vs_eager(torch, fa, tr, (a1, f1), d1)
    rec = {"check": "train_step_program", "compile_step_s": compile_s,
           "compile_step_leaves_state": unchanged, "program": prog.report(), **cmp,
           "step_programs_built": tr.step_programs_built, "card": card}
    log(json.dumps(rec))
    ok = (unchanged and len(prog.graphs) == 1 and within
          and rec["launches"]["program"] == [prog.replay_launches()] == [2 * per_fwd]
          and rec["launches"]["eager"] == [2 * per_fwd] * 2)
    if not ok:
        fail(f"the captured training step: {rec}")
    return {"compile_step_s": compile_s, "memory_bytes": prog.memory_bytes(),
            "capture_s": prog.capture_s, "eager_step_s": rec["wall_s"]["eager"],
            "replayed_step_s": rec["wall_s"]["program"],
            "update_rel_l2_vs_eager": rec["update_rel_l2_vs_eager"]}, step1


def compile_checked(torch, tr, audio, fs):
    """``tr.compile_step`` on a host batch: (the program, its seconds,
    whether the state, ``it`` and the random stream came out as they went
    in)."""
    state = [t.detach().clone() for t in tr._state()]
    rng, it = tr.gen.get_state(), tr.it
    torch.cuda.synchronize()
    t0 = time.time()
    prog = tr.compile_step(audio, fs)
    torch.cuda.synchronize()
    compile_s = time.time() - t0
    unchanged = (all(torch.equal(a, b) for a, b in zip(tr._state(), state)) and tr.it == it
                 and torch.equal(tr.gen.get_state(), rng))
    return prog, compile_s, unchanged


def replay_vs_eager(torch, fa, tr, batch, draws):
    """From the trainer's state, the eager step, the replayed step program
    and the eager step again on one host batch and its draws, the state
    and ``it`` put back after each: the loss, the update's relative L2
    distance from the first eager step's (the second eager step's is the
    eager spread), walls and launches. Returns (that record, whether the
    program's loss is the eager loss within 1e-5 and its update within
    twice the spread, or 1e-5)."""
    (a, f), d = batch, draws
    p1, it = [p.detach().clone() for p in tr.params], tr.it
    res = {}
    for route in ("eager", "program", "eager"):
        restore = tr._snapshot()
        torch.cuda.synchronize()
        n0, t0 = fa.launch_count(), time.time()
        m = tr._train_step(a, f, d, program=route == "program")
        loss = float(m["loss"])
        torch.cuda.synchronize()
        res.setdefault(route, []).append({
            "wall_s": time.time() - t0, "loss": loss, "launches": fa.launch_count() - n0,
            "params": [p.detach().clone() for p in tr.params]})
        restore()
        tr.it = it
    ref = res["eager"][0]["params"]
    den = sum(((b - a).double() ** 2).sum().item() for a, b in zip(p1, ref))

    def dist(ps):
        return (sum(((a - b).double() ** 2).sum().item() for a, b in zip(ps, ref))
                / den) ** 0.5 if den else float("inf")

    rec = {"loss": {k: [r["loss"] for r in v] for k, v in res.items()},
           "update_rel_l2_vs_eager": {k: [dist(r["params"]) for r in v] for k, v in res.items()},
           "wall_s": {k: [r["wall_s"] for r in v] for k, v in res.items()},
           "launches": {k: [r["launches"] for r in v] for k, v in res.items()}}
    spread = rec["update_rel_l2_vs_eager"]["eager"][1]
    loss_e = rec["loss"]["eager"]
    within = (den > 0
              and all(abs(x - loss_e[0]) <= 1e-5 * abs(loss_e[0]) for x in rec["loss"]["program"])
              and all(d <= max(2 * spread, 1e-5) for d in rec["update_rel_l2_vs_eager"]["program"]))
    return rec, within


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
        n0, b0 = fa.launch_count(), self.step_programs_built
        t0 = time.time()
        m = orig(self, audio, fs, draws)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        built = self.step_programs_built - b0
        # a step that builds the step program runs its warm-up step eagerly too
        rec = {"run": 2 if "resumed_from" in expect else 1, "it": self.it,
               "wall_s": time.time() - t0, "launches": fa.launch_count() - n0,
               "step_programs_built": built,
               "expected_launches": launches_per_forward(self.net) * (2 if self.net.remat else 1)
               * (1 + built),
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
          and [s["step_programs_built"] for s in steps] == [1, 0, 0, 0, 1, 0]
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
    timing_bwd = time_kernel_bwd(torch, fa, shapes, "tanh", torch.float32, TRAIN_BATCH)
    log(json.dumps({"timing": "fused_adaln_bwd per training forward (f32, batch 4)",
                    **timing_bwd, "card": card}))
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
                                 "step_program": steps["program"],
                                 "card": card}}))
    return entry["launches"], worst


# ------------------------------------------------------- multi-device (7)

PAR_WORLD = 2              # ranks of phase 7b-7g, sharing the one card over gloo
F32_TOL = 1e-4             # f32 (TF32 off) comparisons of phase 7, max|d| / max|ref|
# 7g's service: the served flagship at 4 deterministic steps
SERVE_CP = ["tester.T=4", "tester.diff_params.same_as_training=False",
            "tester.diff_params.Schurn=0.0"]
# 7c's service: the served flagship at 8 steps (cut from 35 for the time
# budget), held against the one-rank service at the same settings
SERVE_DP = ["tester.T=8"]


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


def phase_parallel_entry(torch, fa, corpus, work, card, cmp_batch, cmp_draws):
    """7a: aid_tpu_torch.train.main with exp.mesh.fsdp over NCCL, one rank
    per card, 2 steps through the captured FSDP step (``compile_step``
    before the first); after step 2, the replayed step against the eager
    step on ``cmp_batch`` and ``cmp_draws`` (``replay_vs_eager``). Its
    launches are counted."""
    import torch.distributed as dist
    from aid_tpu_torch import train as ttrain
    from aid_tpu_torch.training.trainer import Trainer
    from aid_tpu_torch.utils import checkpoint as ckpt
    world = 1
    log(f"== phase 7a: aid_tpu_torch.train.main, exp.mesh.fsdp=true, over NCCL at world size "
        f"{world} ({torch.cuda.device_count()} card(s)), 2 steps replayed from the captured "
        "FSDP step, then replayed against eager")
    md = os.path.join(work, "fsdp_main")
    ov = train_overrides(corpus, md, "exp.total_its=2", "logging.save_interval=2",
                         "logging.log_interval=1", "exp.mesh.distributed=True",
                         "exp.mesh.fsdp=True")
    steps, orig, extra = [], Trainer.train_step, {}

    def timed(self, audio, fs, draws=None):
        if self.it == 0:
            prog, extra["compile_step_s"], extra["compile_step_leaves_state"] = \
                compile_checked(torch, self, audio, fs)
            extra["programs_enabled"] = self.programs_enabled()
            extra["graphs"] = None if prog is None else len(prog.graphs)
        torch.cuda.synchronize()
        n0, b0, t0 = fa.launch_count(), self.step_programs_built, time.time()
        m = orig(self, audio, fs, draws)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        steps.append({"it": self.it, "wall_s": time.time() - t0, "loss": loss,
                      "launches": fa.launch_count() - n0, "backend": dist.get_backend(),
                      "world": dist.get_world_size(), "fsdp": self.fsdp,
                      "step_programs_built": self.step_programs_built - b0,
                      "sharded_tensors": sum(d is not None for d in self.shard_dims)})
        log(json.dumps({"train_step": steps[-1]}))
        if self.it == 2:
            (prog,) = self._step_programs.values()
            extra["replays_of_main"] = prog.replays
            extra["program"] = prog.report()
            extra["vs_eager"], extra["within_eager_spread"] = replay_vs_eager(
                torch, fa, self, cmp_batch, cmp_draws)
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
           # compile_step's warm-up, 2 replays, then 2 eager steps and a replay
           "expected_launches": (1 + 2 + 3) * per_step, "step_s": [s["wall_s"] for s in steps],
           "peak_gb": peak, "checkpoint_it": final["it"],
           "checkpoint_full_shapes": all(t.dim() > 0 for t in final["network"].values()),
           **extra, "card": card}
    log(json.dumps(rec))
    if not (rec["steps"] == [1, 2] and rec["backend"] == "nccl" and rec["group_ended"]
            and all(s["fsdp"] and s["sharded_tensors"] == 0 for s in steps)
            and extra.get("programs_enabled") and extra.get("graphs") == 1
            and extra.get("compile_step_leaves_state")
            and [s["step_programs_built"] for s in steps] == [0, 0]
            and extra.get("replays_of_main") == 2 and extra.get("within_eager_spread")
            and all(s["launches"] == per_step for s in steps)
            and launches == rec["expected_launches"] and final["it"] == 2
            and all(math.isfinite(s["loss"]) for s in steps)):
        fail(f"fsdp training entry point: {rec}")
    return rec


def reference_inputs(np, corpus, work):
    """7b's inputs, made on the host: the training config of the one-rank
    reference, 2 global batches of 4 (mixed rates) and their draws."""
    from aid_tpu_torch import setup as tsetup
    from aid_tpu_torch import train as ttrain
    args = ttrain.compose_args(train_overrides(corpus, os.path.join(work, "ref"),
                                               "exp.lr_rampup_it=1"))
    batches = mixed_batches(np, args, 2)
    p = tsetup.setup_diff_parameters(args).params
    rng = np.random.default_rng(11)
    draws = [numpy_draws(np, p, rng, TRAIN_BATCH, int(args.exp.audio_len)) for _ in batches]
    return args, batches, draws


def one_rank_steps(torch, args, batches, draws):
    """7b's reference: the one-rank trainer's 2 steps (TF32 off) on the
    global batches and their draws."""
    tr = flagship_trainer(torch, args)
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
    return ref


def start_ranks(work):
    """Start PAR_WORLD copies of this script as the ranks of a process group
    (``--rank R WORKDIR``); each imports its modules, then waits for
    ``post_inputs``. Returns the processes."""
    import subprocess
    os.makedirs(work, exist_ok=True)
    port = free_port()
    procs = []
    for r in range(PAR_WORLD):
        # the ranks run eagerly beside this process's work on the same card:
        # expandable segments keep their reserved memory near what they use
        env = dict(os.environ, **rank_env(r, PAR_WORLD, port),
                   PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
        with open(os.path.join(work, f"rank{r}.log"), "w") as out:
            procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank",
                                           str(r), work], env=env, stdout=out,
                                          stderr=subprocess.STDOUT))
    return procs


def post_inputs(work, inputs):
    """The ranks' inputs, written whole before a rank can see the file."""
    import pickle
    tmp = os.path.join(work, "inputs.pkl.tmp")
    with open(tmp, "wb") as f:
        pickle.dump(inputs, f)
    os.replace(tmp, os.path.join(work, "inputs.pkl"))


def join_ranks(work, procs, timeout=900):
    """Wait for the ranks of ``start_ranks``; returns their JSON results. A
    rank that fails or outlives ``timeout`` fails the phase; no rank is left
    running."""
    import subprocess
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


def wait_for(path, timeout=900):
    """Until ``path`` exists or ``timeout`` passes; returns the seconds."""
    t0 = time.time()
    while not os.path.exists(path) and time.time() - t0 < timeout:
        time.sleep(0.2)
    return time.time() - t0


class CardLowWater:
    """The card's least free memory while the context is open, every
    process's use included (``torch.cuda.mem_get_info`` sampled every
    0.25 s on a thread)."""

    def __init__(self, torch):
        self.torch, self.least, self.at_s = torch, None, None

    def __enter__(self):
        import threading
        self.stop, t0 = threading.Event(), time.time()

        def sample():
            while True:
                free, _ = self.torch.cuda.mem_get_info()
                if self.least is None or free < self.least:
                    self.least, self.at_s = free, time.time() - t0
                if self.stop.wait(0.25):
                    return

        self.thread = threading.Thread(target=sample, daemon=True, name="card-low-water")
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join()

    def gb(self):
        return self.least / 2 ** 30


def rank_main(rank, work):
    """One rank of phase 7b-7g: a process group over gloo (two ranks share
    the card), the kernel against its plain version, then each path (7c-7g,
    then 7b once the parent is done) with the launch count set to 0 before
    it and read after it."""
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
    from aid_tpu_torch.serving import InpaintingService  # noqa: F401 (imported while waiting)
    from aid_tpu_torch.training.trainer import Trainer  # noqa: F401
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    path = os.path.join(work, "inputs.pkl")
    while not os.path.exists(path):              # the parent posts them; no CUDA until then
        time.sleep(0.1)
    with open(path, "rb") as f:
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
    seconds = {}

    def timed(name, fn, *a):
        t0 = time.time()
        res = fn(*a)
        seconds[name] = time.time() - t0
        return res

    out["serve"] = timed("7c", rank_serve, torch, fa, np, inp, rank, work)
    if rank == PAR_WORLD - 1:                    # 7c's reference, off the parent's path
        np.save(os.path.join(work, "serve_dp_reference.npy"),
                timed("7c-reference", serve_dp_reference, torch, inp["request_b"]))
    out["tp"], out["cp"] = timed("7d-e", rank_scores, torch, fa)
    out["full_cp"] = timed("7f", rank_full_cp, torch, fa)
    out["serve_cp"] = timed("7g", rank_serve_cp, torch, fa, np, inp)
    # the training steps and their programs' pools take most of the card:
    # they run once the parent's work beside the ranks is done
    seconds["waited_for_parent"] = wait_for(os.path.join(work, "parent_done"))
    dist.barrier()
    out["train"] = timed("7b", rank_train, torch, fa, np, inp, rank, world, work)
    out["seconds"] = seconds
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def params_cpu(tr):
    return [p.detach().cpu() for p in tr.params]


def eager_spread(torch, tr, local):
    """The dp step's eager reference on this rank's rows (``local``: host
    batches and draws): step 1, then step 2 twice from step 1's state; the
    state and ``it`` are put back to where they started. Returns (step 1's
    parameters, both step 2's parameters on the host, both step 2's
    walls)."""
    it0, start = tr.it, tr._snapshot()
    tr._train_step(*local[0], program=False)
    p1, after, walls = params_cpu(tr), [], []
    for _ in range(2):
        back = tr._snapshot()
        torch.cuda.synchronize()
        t0 = time.time()
        tr._train_step(*local[1], program=False)
        torch.cuda.synchronize()
        walls.append(time.time() - t0)
        after.append(params_cpu(tr))
        back()
        tr.it = it0 + 1
    start()
    tr.it = it0
    gc.collect()
    torch.cuda.empty_cache()     # the eager steps' blocks, before the program's pool
    return p1, after, walls


def rel_l2(ps, ref, base):
    """||ps - ref|| / ||ref - base|| over every tensor (the update's scale)."""
    den = sum(((b - a).double() ** 2).sum().item() for a, b in zip(base, ref))
    num = sum(((a - b).double() ** 2).sum().item() for a, b in zip(ps, ref))
    return (num / den) ** 0.5 if den else float("inf")


def rank_train(torch, fa, np, inp, rank, world, work):
    """7b on this rank's rows of the global batch and draws (TF32 off):
    dp, the eager DDP step's reference (``eager_spread``), then 2 steps
    through the dp step program (two graphs around the all-reduce, built
    at the first step) whose update is held against the eager one; fsdp,
    2 steps, eagerly by rule (gloo). Rank 0 keeps the gathered
    parameters; each rank releases its trainer and program before the
    next mode's."""
    import torch.distributed as dist
    from aid_tpu_torch import train as ttrain
    res = {}
    k = TRAIN_BATCH // world
    rows = slice(rank * k, (rank + 1) * k)
    local = [(a[rows], f[rows], [{n: v[rows] for n, v in d[0].items()}])
             for (a, f), d in zip(inp["batches"], inp["draws"])]
    for mode, extra in (("dp", []), ("fsdp", ["exp.mesh.fsdp=True"])):
        args = ttrain.compose_args(train_overrides(
            inp["corpus"], os.path.join(work, mode), "exp.lr_rampup_it=1",
            f"exp.mesh.dp={world}", *extra))
        tr = flagship_trainer(torch, args)
        rec = {"wrapper": type(tr.model).__name__, "loss": [], "grad_norm": [], "step_s": [],
               "programs_enabled": tr.programs_enabled()}
        if mode == "fsdp":
            rec["eager_because"] = ("FSDP2's all-gathers and reduce-scatters sit inside its "
                                    "one graph, and a capture holds NCCL's collectives only: "
                                    f"this group runs {dist.get_backend(tr.mesh.get_group())}")
        else:
            p1, eager, rec["eager_step_s"] = eager_spread(torch, tr, local)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_count()                  # 7b's path starts here
        for a, f, d in local:
            t0 = time.time()
            m = tr.train_step(a, f, d)
            rec["loss"].append(float(m["loss"]))
            rec["grad_norm"].append(float(m["grad_norm"]))
            torch.cuda.synchronize()
            rec["step_s"].append(time.time() - t0)
        rec["launches"] = fa.launch_count()      # ... and ends here
        rec["step_programs_built"] = tr.step_programs_built
        # a step that builds the program runs its warm-up step eagerly too
        rec["expected_launches"] = ((len(local) + tr.step_programs_built) * 2
                                    * launches_per_forward(tr.net))
        rec["peak_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
        rec["resident_gb"] = torch.cuda.memory_allocated() / 2 ** 30
        if mode == "dp":
            (prog,) = tr._step_programs.values()
            rec["program"] = prog.report()
            # the hook alone (every rank calls it): the all-reduce the two
            # graphs wait for, where DDP overlaps its buckets' with the backward
            torch.cuda.synchronize()
            t0 = time.time()
            prog.hook(prog.carry)
            torch.cuda.synchronize()
            rec["all_reduce_s"], rec["all_reduce_bytes"] = (
                time.time() - t0, prog.carry.numel() * prog.carry.element_size())
            got = params_cpu(tr)
            rec["update_rel_l2_vs_eager"] = {"program": rel_l2(got, eager[0], p1),
                                             "eager": rel_l2(eager[1], eager[0], p1)}
            del got, eager, p1, prog
        params = tr._full(tr.params)             # gathered on rank 0 under fsdp
        if params is not None:
            torch.save(dict(zip(tr.names, params)), os.path.join(work, f"{mode}_params.pt"))
        res[mode] = rec
        del tr, params
        gc.collect()
        torch.cuda.empty_cache()
    return res


def rank_serve(torch, fa, np, inp, rank, work):
    """7c: phase 5's request (b) served by shard() over dp (one row of each
    2-row round per rank) at SERVE_DP's settings, each rank's row through
    its program (``precompile`` builds it first); then the same request
    with the programs off (``heun_sample`` eagerly on the same noise). The
    answer is saved for the parent to hold against the one-rank
    service's."""
    from aid_tpu_torch.models.unet_cqt import MAIN_SCALE
    from aid_tpu_torch.serving import InpaintingService
    svc = InpaintingService.from_config(SERVE_DP)
    svc.network.init_weights(0, gate_scale=MAIN_SCALE)   # phase 5's weights
    svc.shard()
    torch.cuda.synchronize()
    t0 = time.time()
    svc.precompile()
    torch.cuda.synchronize()
    precompile_s = time.time() - t0
    rounds, run = [], svc._run_batch

    def counted(xb, mb, seed):
        rounds.append(xb.shape[0])
        return run(xb, mb, seed)

    svc._run_batch = counted
    req = inp["request_b"]
    audio_s = len(req["audio"]) / req["fs"]
    torch.cuda.synchronize()
    fa.reset_launch_count()                      # 7c's path starts here
    t0 = time.time()
    got = svc.inpaint(req["audio"], req["mask"], req["fs"], seed=1)
    wall = time.time() - t0
    launches = fa.launch_count()                 # ... and ends here
    del svc._run_batch   # no cycle: freed by reference counting
    np.save(os.path.join(work, f"serve_dp_rank{rank}.npy"), got)
    obs = req["mask"] > 0.5
    steps = 2 * svc.sampler.cfg.T - 1
    programs = program_reports(svc.sampler)
    rec = {"T": svc.sampler.cfg.T, "rounds": rounds, "max_batch": svc.max_batch,
           "wall_s": wall, "rtf": audio_s / wall, "precompile_s": precompile_s,
           "observed_exact": bool(np.array_equal(got[obs], req["audio"][obs])),
           "finite": bool(np.isfinite(got).all()), "launches": launches,
           "expected_launches": 90 * steps * len(rounds),
           "programs_enabled": svc.sampler.programs_enabled(),
           "program_rows": [p["shape"][0] for p in programs],
           "replays": [p["replays"] for p in programs],
           "capture_s": [p["capture_s"] for p in programs],
           "memory_bytes": [p["memory_bytes"] for p in programs]}
    svc.sampler.programs_enabled = lambda: False   # the same request, eagerly
    try:
        torch.cuda.synchronize()
        t0 = time.time()
        eager = svc.inpaint(req["audio"], req["mask"], req["fs"], seed=1)
        rec["eager_wall_s"] = time.time() - t0
    finally:
        del svc.sampler.programs_enabled
    rec["eager_rtf"] = audio_s / rec["eager_wall_s"]
    rec["program_vs_eager_max_abs"] = float(np.abs(got - eager).max())
    del svc
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def serve_dp_reference(torch, request_b):
    """7c's reference: request (b) answered by the one-rank service at
    SERVE_DP's settings (its precompiled programs; not sharded, so on a
    rank it is the one-rank answer)."""
    from aid_tpu_torch.models.unet_cqt import MAIN_SCALE
    from aid_tpu_torch.serving import InpaintingService
    svc = InpaintingService.from_config(SERVE_DP)
    svc.network.init_weights(0, gate_scale=MAIN_SCALE)   # phase 5's weights
    svc.precompile()
    ans = svc.inpaint(request_b["audio"], request_b["mask"], request_b["fs"], seed=1)
    del svc
    gc.collect()
    torch.cuda.empty_cache()
    return ans


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
        programs_enabled = svc.sampler.programs_enabled()
    finally:
        ring.set_cp_mesh(None)
    obs = req["mask"] > 0.5
    steps = 2 * svc.sampler.cfg.T - 1
    rec = {"T": svc.sampler.cfg.T, "wall_s": wall, "rtf": len(req["audio"]) / req["fs"] / wall,
           "programs_enabled": programs_enabled,
           "rel_err": rel(torch.from_numpy(got), torch.from_numpy(ref)),
           "observed_exact": bool(np.array_equal(got[obs], req["audio"][obs])),
           "finite": bool(np.isfinite(got).all()), "launches": launches,
           "expected_launches": 90 * steps, "levels_sharded": counts.get("levels_sharded", 0),
           "levels_replicated": counts.get("levels_replicated", 0)}
    del svc
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def phase_parallel(torch, fa, np, work, card, request_a, request_b, beside_steps,
                   beside_scores):
    """Phase 7: 7c-7g, then 7b, on PAR_WORLD ranks sharing the card
    (gloo), the last rank also 7c's one-rank reference; beside their 7c-7g
    this process runs the one-rank training reference, 7a and
    ``beside_scores()``, then
    lets the ranks' 7b start and runs ``beside_steps()`` (light on device
    memory: the ranks' training steps and their programs' pools take most
    of the card). Every rank path is held against one rank. Returns the
    launches, the largest kernel error and what ``beside_steps`` and
    ``beside_scores`` returned."""
    log("== phase 7: multi-device training and serving over torch.distributed")
    corpus = os.path.join(work, "maestro")
    t_phase = time.time()
    rank_dir = os.path.join(work, "ranks")
    procs = start_ranks(rank_dir)                # importing while the inputs are made
    with killed_on_failure(procs):
        args, batches, draws = reference_inputs(np, corpus, work)
        log(f"== phase 7b-7g: {PAR_WORLD} ranks on one card over gloo: shard() over dp on "
            f"phase 5's request (b) at {' '.join(SERVE_DP)}, a tp=2 and a cp=2 guided score, "
            "a full-score cp=2 score, shard() over (dp=1, cp=2) on phase 5's request (a) at "
            "T=4 and 7c's one-rank reference (beside them this process: 7b's one-rank "
            "reference, 7a, 8a-8b), then dp and fsdp steps (beside them: 10a)")
        t0 = time.time()
        with CardLowWater(torch) as low:
            post_inputs(rank_dir, {"corpus": corpus, "batches": batches, "draws": draws,
                                   "request_a": request_a, "request_b": request_b})
            log(f"== phase 7b reference: the one-rank trainer's 2 steps at batch {TRAIN_BATCH}, "
                "f32, TF32 off")
            ref = one_rank_steps(torch, args, batches, draws)
            entry = phase_parallel_entry(torch, fa, corpus, work, card, batches[1], draws[1])
            gc.collect()
            torch.cuda.empty_cache()
            last = beside_scores()
            gc.collect()
            torch.cuda.empty_cache()
            open(os.path.join(rank_dir, "parent_done"), "w").close()   # 7b may start
            first = beside_steps()
            parent_s = time.time() - t0
            ranks = join_ranks(rank_dir, procs)
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
        got = torch.load(os.path.join(rank_dir, f"{mode}_params.pt"))
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
               "launches": [r["launches"] for r in recs],
               "programs_enabled": [r["programs_enabled"] for r in recs],
               "step_programs_built": [r["step_programs_built"] for r in recs], "card": card}
        if mode == "dp":
            rec.update(
                eager_step_s=[r["eager_step_s"] for r in recs],
                all_reduce_s=[r["all_reduce_s"] for r in recs],
                all_reduce_bytes=recs[0]["all_reduce_bytes"],
                update_rel_l2_vs_eager=[r["update_rel_l2_vs_eager"] for r in recs],
                program=[{k: r["program"][k] for k in ("graphs", "hook", "replays", "capture_s",
                                                       "memory_bytes", "launches_per_replay")}
                         for r in recs])
        else:
            rec["eager_because"] = recs[0]["eager_because"]
        log(json.dumps(rec))
        launches += sum(rec["launches"])
        if not (rec["loss_rel_err"] <= F32_TOL and rec["grad_norm_rel_err"] <= F32_TOL
                and rec["update_rel_l2"] <= 1e-3 and dev <= 0.1 * moved
                and all(r["launches"] == r["expected_launches"] for r in recs)):
            problems.append(f"{mode} steps against the one-rank steps")
        if mode == "dp" and not all(
                r["programs_enabled"] and r["step_programs_built"] == 1
                and r["program"]["graphs"] == 2 and r["program"]["hook"]
                and r["program"]["replays"] == len(r["step_s"])
                and r["update_rel_l2_vs_eager"]["program"]
                <= max(2 * r["update_rel_l2_vs_eager"]["eager"], 1e-5) for r in recs):
            problems.append("the dp step program against the eager DDP step")
        if mode == "fsdp" and not all(not r["programs_enabled"]
                                      and r["step_programs_built"] == 0 for r in recs):
            problems.append("fsdp over gloo runs eagerly")
        summary[mode] = {"step_s": float(np.median([s for r in recs for s in r["step_s"][1:]])),
                         "peak_gb_per_rank": max(rec["peak_gb"]),
                         "resident_gb_per_rank": max(rec["resident_gb"])}
        if mode == "dp":
            summary[mode].update(
                eager_step_s=float(np.median([s for r in recs for s in r["eager_step_s"]])),
                memory_bytes_per_rank=[r["program"]["memory_bytes"] for r in recs])
    serve = [r["serve"] for r in ranks]
    answers = [np.load(os.path.join(rank_dir, f"serve_dp_rank{r}.npy"))
               for r in range(PAR_WORLD)]
    serve_ref = np.load(os.path.join(rank_dir, "serve_dp_reference.npy"))
    rec = {"check": "shard_dp_serving", **serve[0], "tol": BF16_TOL,
           "rel_err": rel(torch.from_numpy(answers[0]), torch.from_numpy(serve_ref)),
           "ranks_agree": all(np.array_equal(a, answers[0]) for a in answers),
           "launches": [s["launches"] for s in serve], "card": card}
    log(json.dumps(rec))
    launches += sum(s["launches"] for s in serve)
    rec.update({k: [s[k] for s in serve] for k in (
        "program_vs_eager_max_abs", "rtf", "eager_rtf", "memory_bytes", "replays")})
    if not (rec["finite"] and rec["observed_exact"] and rec["rel_err"] <= BF16_TOL
            and rec["ranks_agree"] and rec["rounds"] == [2, 2]
            and all(s["programs_enabled"] and s["program_rows"] == [1]
                    and s["replays"] == [s["T"] * len(s["rounds"])]
                    and s["program_vs_eager_max_abs"] == 0.0 for s in serve)
            and all(s["launches"] == s["expected_launches"] for s in serve)):
        problems.append("dp serving against the one-rank answer and its eager run")
    summary["dp_serving_rtf"] = [s["rtf"] for s in serve]
    summary["dp_serving_eager_rtf"] = [s["eager_rtf"] for s in serve]
    eager_by_rule = ("eagerly: its collectives sit inside every score, and a CUDA graph "
                     "holds only NCCL's, which needs a card a rank")
    for name in ("tp", "cp"):
        recs = [r[name] for r in ranks]
        rec = {"check": f"{name}_guided_score", **recs[0], "runs": eager_by_rule,
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
    rec = {"check": "full_score_cp_guided_score", **recs[0], "runs": eager_by_rule,
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
           "runs": eager_by_rule,
           "ranks_agree": all(s["rel_err"] == serve[0]["rel_err"] for s in serve),
           "launches": [s["launches"] for s in serve], "card": card}
    log(json.dumps(rec))
    launches += sum(s["launches"] for s in serve)
    if not (rec["finite"] and rec["observed_exact"] and rec["rel_err"] <= BF16_TOL
            and rec["ranks_agree"] and rec["levels_replicated"] == 0
            and not any(s["programs_enabled"] for s in serve)
            and all(s["launches"] == s["expected_launches"] for s in serve)):
        problems.append("(dp=1, cp=2) serving against the one-rank answer")
    summary["cp_serving_rtf"] = serve[0]["rtf"]
    summary.update(fsdp_entry_step_s=entry["step_s"], fsdp_entry_peak_gb=entry["peak_gb"],
                   fsdp_entry_vs_eager_wall_s=entry["vs_eager"]["wall_s"],
                   fsdp_entry_memory_bytes=entry["program"]["memory_bytes"],
                   card_free_low_water_gb=low.gb(), card_free_low_water_at_s=low.at_s,
                   ranks_wall_s=ranks_wall, parent_meanwhile_s=parent_s,
                   rank_seconds=[r["seconds"] for r in ranks],
                   phase_s=time.time() - t_phase, card=card)
    log(json.dumps({"parallel": summary}))
    if problems:
        fail("phase 7: " + "; ".join(problems))
    return launches, max(r["kernel_vs_plain"]["max_abs_err"] for r in ranks), first, last


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
    """Counts the denoiser evaluations the device runs: ``edm.denoiser``
    calls (the samplers look it up at call time) except those a CUDA graph
    capture records, plus those each replay of a program's captured step
    runs."""
    import torch
    from aid_tpu_torch.diffusion import edm
    from aid_tpu_torch.sampling import program
    orig, orig_step, calls = edm.denoiser, program.HeunProgram._step, [0]

    def counted(*a, **k):
        if not torch.cuda.is_current_stream_capturing():
            calls[0] += 1
        return orig(*a, **k)

    def step(self, name):
        if self.graphs is not None:
            calls[0] += self.scores[name]
        return orig_step(self, name)

    edm.denoiser, program.HeunProgram._step = counted, step
    try:
        yield calls
    finally:
        edm.denoiser, program.HeunProgram._step = orig, orig_step


class DemoMemory:
    """Device memory around each in-training demo (``Trainer.heavy_logging``
    patched while the context is open): the training run's peak before it,
    what was allocated before it, and what stays allocated and reserved
    after it (the tester releases the demo's program when it is done)."""

    def __init__(self, torch):
        self.torch, self.recs = torch, []

    def __enter__(self):
        from aid_tpu_torch.training.trainer import Trainer
        torch, recs, orig = self.torch, self.recs, Trainer.heavy_logging
        self.orig = orig
        torch.cuda.reset_peak_memory_stats()      # the training run's own peak

        def heavy_logging(tr):
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            base, reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
            orig(tr)
            torch.cuda.synchronize()
            recs.append({"it": tr.it, "training_peak_bytes": peak, "allocated_before": base,
                         "held_after_bytes": torch.cuda.memory_allocated() - base,
                         "reserved_growth_bytes": torch.cuda.memory_reserved() - reserved})

        Trainer.heavy_logging = heavy_logging
        return self

    def __exit__(self, *exc):
        from aid_tpu_torch.training.trainer import Trainer
        Trainer.heavy_logging = self.orig

    def report(self):
        return self.recs


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


def phase_testing_ab(torch, fa, np, work, card):
    """8a-8b on the evaluation path, launches counted (beside phase 7's
    ranks: each tester's programs are released as soon as it is done)."""
    from aid_tpu_torch.utils import checkpoint as ckpt
    corpus, md = os.path.join(work, "maestro"), os.path.join(work, "main")
    latest = ckpt.list_checkpoints(md, "22k_8s")[-1]
    ema = ckpt.load(latest)["ema"]
    log(f"== phase 8a: aid_tpu_torch.test.main, inpainting at T=35 on one test file, weights "
        f"from the latest checkpoint in {md}")
    torch.cuda.synchronize()
    fa.reset_launch_count()                      # 8a-8b's evaluation path starts here
    with counting_denoiser() as calls, checked_writes(np) as written, \
            built_programs() as built:
        t0 = time.time()
        ta = run_test_main(eval_overrides(corpus, md, "tester.modes=['inpainting']"))
        wall_a, calls_a, built_a = time.time() - t0, calls[0], list(built)
        ta.sampler.release_programs()
        torch.cuda.empty_cache()
        log(f"== phase 8b: aid_tpu_torch.test.main, the other nine modes at T={EVAL_T}")
        t0 = time.time()
        tb = run_test_main(eval_overrides(
            corpus, md, f"tester.T={EVAL_T}", f"tester.modes={OTHER_MODES}".replace(" ", ""),
            "tester.unconditional.num_samples=1", "tester.autoregressive.num_samples=2"))
        wall_b, calls_b, built_b = time.time() - t0, calls[0] - calls_a, built[len(built_a):]
        tb.sampler.release_programs()
        torch.cuda.synchronize()
        launches = fa.launch_count()             # ... and ends here

    loaded = all(torch.equal(p, ema[n].to(p.dtype).to(p.device))
                 for n, p in ta.network.named_parameters())
    # trajectories of 8b: unconditional 1, MUSHRA 4, short gaps, spectrogram,
    # bwe, declipping, comp_sens, phase retrieval 1 each, autoregressive 2
    trajectories_b = 1 + 4 + 6 + 2
    # each program built (a: inpainting; b: one per task, the unconditional
    # and inpainting ones shared by the modes of one shape) ran its two steps
    # once, eagerly, before its capture
    builds = {"a": len(built_a), "b": len(built_b)}
    expect_calls = {"a": 2 * 35 - 1 + warmup_scores(built_a),
                    "b": (2 * EVAL_T - 1) * trajectories_b + warmup_scores(built_b)}
    got_calls = {"a": calls_a, "b": calls_b}
    per_fwd = launches_per_forward(ta.network)                  # 90 on the flagship
    base = ta.base_dir
    scored = check_metrics(base)
    orig = audio_io_read(os.path.join(base, "inpainting", "original", "test_piece.wav"))
    rec = audio_io_read(os.path.join(base, "inpainting", "reconstructed", "test_piece.wav"))
    gap = np.flatnonzero(ta.prepare_mask()[0] == 0)
    hann = ta.sampler.hann_size
    far = np.ones(len(orig), bool)
    far[max(gap[0] - hann, 0):gap[-1] + 1 + hann] = False
    far_err = float(np.abs(rec[far] - orig[far]).max())
    audio_s = ta.audio_len / ta.fs
    rec_a = {"check": "testing_a_b", "loaded_latest_checkpoint": os.path.basename(latest),
             "weights_equal_checkpoint_ema": loaded, "inpainting_T35_s": ta.seconds["inpainting"],
             "inpainting_rtf": audio_s / ta.seconds["inpainting"], "main_a_wall_s": wall_a,
             f"seconds_per_mode_T{EVAL_T}": tb.seconds, "main_b_wall_s": wall_b,
             "denoiser_calls": got_calls, "expected_calls": expect_calls,
             "programs_built": builds, "launches": launches,
             "launches_per_denoiser_call": per_fwd, "expected_launches": per_fwd * sum(
                 got_calls.values()), "wavs_written_finite": len(written),
             "metrics_files": scored, "observed_max_abs_err": far_err, "observed_tol": LSB,
             "gap_rms": float(np.sqrt(np.mean(rec[gap] ** 2))), "card": card}
    log(json.dumps(rec_a))
    ok = (loaded and got_calls == expect_calls and launches == rec_a["expected_launches"]
          and builds == {"a": 1, "b": 7}
          and set(tb.seconds) == set(OTHER_MODES) and scored == 6 and far_err <= LSB
          and rec_a["gap_rms"] > 0)
    if not ok:
        fail(f"evaluation path: {rec_a}")
    del ta, tb
    gc.collect()
    torch.cuda.empty_cache()
    return launches, per_fwd, {k: rec_a[k] for k in (
        "inpainting_T35_s", "inpainting_rtf", f"seconds_per_mode_T{EVAL_T}")}


def audio_io_read(path):
    from aid_tpu_torch.data import audio_io
    return audio_io.read(path)[0]


def phase_testing_c(torch, fa, np, work, card, ab):
    """8c on the evaluation path (launches counted), then 8d and 8e; ``ab``
    is what ``phase_testing_ab`` returned."""
    from aid_tpu_torch import train as ttrain
    launches_ab, per_fwd, summary = ab
    corpus = os.path.join(work, "maestro")
    log("== phase 8c: aid_tpu_torch.train.main, one step with heavy_log_interval 1 (the "
        "in-training demo)")
    demo_md = os.path.join(work, "demo")
    demo_peak = DemoMemory(torch)
    torch.cuda.synchronize()
    fa.reset_launch_count()                      # 8c's evaluation path starts here
    with counting_denoiser() as calls, checked_writes(np) as written, \
            built_programs() as built, demo_peak:
        t0 = time.time()
        if ttrain.main(train_overrides(corpus, demo_md, "exp.total_its=1",
                                       "logging.heavy_log_interval=1", f"tester.T={EVAL_T}",
                                       "tester.unconditional.num_samples=1")) != 0:
            fail("the demo's train.main returned non-zero")
        wall_c = time.time() - t0
        torch.cuda.synchronize()
        launches = fa.launch_count()             # ... and ends here
    demo_wav = os.path.join(demo_md, "heavy_logging", "it_1", "uncond_0.wav")
    if demo_wav not in written:
        fail(f"the in-training demo wrote no {demo_wav}")
    demo = audio_io_read(demo_wav)
    expect = 2 * EVAL_T - 1 + warmup_scores(built)
    rec = {"check": "testing_c", "demo_main_wall_s": wall_c, "denoiser_calls": calls[0],
           "expected_calls": expect, "programs_built": len(built),
           "demo_program": built, "demo_memory": demo_peak.report(),
           "launches": launches, "expected_launches": per_fwd * (calls[0] + 4),
           "wavs_written_finite": len(written),
           "demo_rms": float(np.sqrt(np.mean(demo ** 2))), "card": card}
    log(json.dumps(rec))
    # + 4: one remat training step's forward and recomputation, twice: the
    # step program's warm-up, then its replay
    if not (calls[0] == expect and len(built) == 1 and launches == rec["expected_launches"]
            and rec["demo_rms"] > 0):
        fail(f"evaluation path (the in-training demo): {rec}")
    gc.collect()
    torch.cuda.empty_cache()
    plain = phase_testing_plain(torch, fa, np, corpus, work)
    launches_tasks, tasks = phase_task_programs(torch, fa, np, card)
    return launches_ab + launches + launches_tasks, summary | plain | {
        "demo_memory": demo_peak.report(),
        "demo_program_memory_bytes": [r["memory_bytes"] for r in built],
        "task_programs": tasks}


TASK_PROGRAMS = ["spectrogram_inpainting", "bwe", "declipping", "phase_retrieval", "compsens",
                 "rid"]


def task_call(torch, s, task, x, nz):
    """One call of the sampler ``s``'s ``task`` on the signal ``x`` [1, L]
    (the evaluation modes' observations), noise ``nz``; "rid" is guided
    inpainting of a 1500 ms centre gap (at most L/4) with a recording
    sampler."""
    from aid_tpu_torch.sampling import degradations as degr
    stft = s.args.tester.spectrogram_inpainting.stft
    L, fs = x.shape[-1], float(s.args.exp.sample_rate)
    if task == "spectrogram_inpainting":
        n_fft, hop = int(stft.n_fft), int(stft.hop_length)
        m = torch.ones(n_fft // 2 + 1, 1 + (L + n_fft - L % n_fft) // hop, device=x.device)
        m[50:200, 300:380] = 0.0
        return s.predict_spectrogram_inpainting(degr.spectral_mask(m, stft)(x), m, **nz)
    if task == "bwe":
        return s.predict_bwe(degr.bwe_lowpass("firwin", 200, 1000.0, fs)(x), 1000.0, fs, **nz)
    if task == "declipping":
        cv = degr.clip_value_from_sdr(x, 3.0)
        return s.predict_declipping(degr.hard_clip(cv)(x), cv, **nz)
    if task == "phase_retrieval":
        return s.predict_phase_retrieval(degr.stft_magnitude(stft)(x), tuple(x.shape), **nz)
    if task == "compsens":
        gen = torch.Generator(device=x.device).manual_seed(1)
        m = degr.compsens_mask(tuple(x.shape), 20.0, gen, x.device)
        return s.predict_compsens(x * m, m, **nz)
    gap = min(int(1.5 * fs), L // 4)
    mask = torch.ones_like(x)
    mask[:, (L - gap) // 2:(L + gap) // 2] = 0.0
    return s.predict_inpainting(x * mask, mask, **nz)


def phase_task_programs(torch, fa, np, card):
    """8e: the five other tasks and ``rid`` through their programs at full
    flagship width, one row, T=EVAL_T, bf16 (seeded weights, trained-like
    gates), under cuDNN's deterministic switch: each equal to the same task
    run eagerly on the same noise and inputs (x and, for rid, every Record
    field), bit for bit, with its capture time,
    ``memory_bytes()`` and launches; a second run replays the same program
    (no new one is built) and launches what the program recorded, read from
    the counter; then one task's program built with the plain version
    against its kernel program."""
    from aid_tpu_torch import setup as tsetup
    from aid_tpu_torch.models.unet_cqt import MAIN_SCALE
    from aid_tpu_torch.sampling import heun
    from aid_tpu_torch.utils.config import compose
    log(f"== phase 8e: the other tasks' and rid's programs against eager heun_sample, full "
        f"width, T={EVAL_T}, bf16, cuDNN deterministic")
    # with TF32 off cuDNN's gradient of BWE's one-channel conv1d is not
    # deterministic (scripts/probe_spread_torch.py bwe): under its
    # deterministic switch every program must equal its eager run exactly
    torch.backends.cudnn.deterministic = True
    args = compose(overrides=[f"tester.T={EVAL_T}"])
    net = tsetup.setup_network(args, device="cuda", seed=0)
    net.init_weights(0, gate_scale=MAIN_SCALE)             # trained-like gates
    diff = tsetup.setup_diff_parameters(args)
    L, dev = int(args.exp.audio_len), next(net.parameters()).device
    x = torch.from_numpy(music(np, L, int(args.exp.sample_rate), 41))[None].to(dev)
    gen = torch.Generator(device=dev).manual_seed(8)
    per_fwd = launches_per_forward(net)
    launches, out, answers = 0, {}, {}
    for task in TASK_PROGRAMS:
        s = tsetup.setup_sampler(args, net, diff, rid=task == "rid")
        prior, churn = heun.draw_noise((1, L), s.cfg.T, gen, dev)
        nz = dict(prior=prior, churn=churn)
        torch.cuda.synchronize()
        fa.reset_launch_count()
        t0 = time.time()
        got = task_call(torch, s, task, x, nz)
        torch.cuda.synchronize()
        wall, n = time.time() - t0, fa.launch_count()
        (prog,) = s._programs.values()
        n1, t0 = fa.launch_count(), time.time()
        again = task_call(torch, s, task, x, nz)        # replays only
        torch.cuda.synchronize()
        replay_s, n_again = time.time() - t0, fa.launch_count() - n1
        same = list(s._programs.values()) == [prog]
        again = again[0] if task == "rid" else again
        s.programs_enabled = lambda: False
        t0 = time.time()
        ref = task_call(torch, s, task, x, nz)
        torch.cuda.synchronize()
        eager_s = time.time() - t0
        got, ref = ([got[0], *got[1]], [ref[0], *ref[1]]) if task == "rid" else ([got], [ref])
        diff_abs = max(float((g.float() - r.float()).abs().max()) for g, r in zip(got, ref))
        rel = max(float((g.float() - r.float()).abs().max() / r.float().abs().max())
                  for g, r in zip(got, ref))
        rep = prog.report()
        out[task] = {"max_abs_diff": diff_abs, "rel_err": rel, "capture_s": rep["capture_s"],
                     "memory_bytes": rep["memory_bytes"], "static_bytes": rep["static_bytes"],
                     "key": rep["key"], "launches": n, "replayed_run_launches": n_again,
                     "one_program": same, "build_and_run_s": wall,
                     "replayed_run_s": replay_s, "eager_s": eager_s, "record_fields": len(got),
                     "replay_rel_diff": float((again.float() - got[0].float()).abs().max()
                                              / got[0].float().abs().max())}
        ok = (rep["graphs"] and diff_abs == 0.0 and out[task]["replay_rel_diff"] == 0.0
              and all(torch.isfinite(g).all() for g in got)
              and n == per_fwd * (rep["scores"]["body"] + rep["scores"]["last"])
              + rep["launches_per_run"]
              and rep["launches_per_run"] == per_fwd * rep["scores_per_run"]
              and same and n_again == rep["launches_per_run"]
              and len(got) == (7 if task == "rid" else 1))
        log(json.dumps({"check": "task_program", "task": task, **out[task], "card": card}))
        if not ok:
            fail(f"the {task} program: {out[task]}")
        launches += n + n_again
        answers[task] = (got[0], nz)
        del s, prog, got, ref, again
        torch.cuda.empty_cache()
    # the same bwe program built with the plain version
    s = tsetup.setup_sampler(args, net, diff)
    kernel, nz = answers["bwe"]
    with plain_forced(fa):
        fa.reset_launch_count()
        plain = task_call(torch, s, "bwe", x, nz)
        torch.cuda.synchronize()
        plain_launches = fa.launch_count()
    rel = float((kernel.float() - plain.float()).abs().max() / plain.float().abs().max())
    rec = {"check": "task_program_kernel_vs_plain", "task": "bwe", "rel_err": rel,
           "tol": BF16_TOL, "plain_launches": plain_launches,
           "plain_program_graphs": next(iter(s._programs.values())).graphs is not None}
    log(json.dumps(rec))
    if not (rel <= BF16_TOL and plain_launches == 0 and rec["plain_program_graphs"]):
        fail(f"the bwe program, kernel vs plain: {rec}")
    del s, net
    torch.backends.cudnn.deterministic = False
    gc.collect()
    torch.cuda.empty_cache()
    out["bwe_kernel_vs_plain_rel_err"] = rel
    return launches, out


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
        # drop the instance's attribute: setting the bound method back on the
        # instance would be a cycle (tester -> method -> tester) that keeps the
        # tester's programs alive until a collection
        del tester._save_triplet
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
        with counted(fa, launches, "learning"), built_programs() as built:
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
    # two sampling runs (untrained, trained), each through a program whose
    # warm-up evaluated its steps once; the training steps replay the step
    # program, whose build ran one step eagerly
    (step_prog,) = res["step_programs"]
    expected = (per_fwd * (res["its"] + 2 * scores + warmup_scores(built))
                + step_prog["warmup_launches"])
    rec = {"check": "learning_gate", **{k: res[k] for k in (
        "its", "L", "dtype", "snr_untrained_db", "snr_trained_db", "snr_gain_db",
        "lsd_gap_trained", "lsd_gap_untrained", "lsd_gap_ratio", "s_per_it", "train_s",
        "sample_untrained_s", "sample_trained_s", "launches_per_train_step",
        "launches_per_sampling_run")},
           "gates": {"min_snr_gain_db": cfg["min_gain_db"], "max_lsd_ratio": cfg["max_lsd_ratio"]},
           "pass": res["ok"], "launches": launches["learning"], "expected_launches": expected,
           "programs": built, "step_program": step_prog,
           "plain_vs_kernel_rel_err": rel_plain, "plain_launches": plain_launches,
           "tol": BF16_TOL, "launch_shapes": {f"{r}x{c}": n for (r, c), n in sorted(shapes.items())},
           "launch_shapes_max_abs_err": err, "card": card}
    log(json.dumps(rec))
    if not (res["ok"] and rel_plain <= BF16_TOL and plain_launches == 0 and len(built) == 2
            and launches["learning"] == expected and np.isfinite(rec_plain).all()
            and step_prog["graph"] and step_prog["replays"] == res["its"]
            and step_prog["launches_per_replay"] == per_fwd == step_prog["warmup_launches"]):
        fail(f"the learning gate: {rec}")
    del net, res
    gc.collect()
    torch.cuda.empty_cache()
    return err, rec


def tools_evals(fa, np, md, ck4, synth, launches):
    """10c-10d: both evaluation scripts on phase 6e's checkpoints."""
    per_fwd = FLAGSHIP_LAUNCHES
    scores = 2 * TOOLS_T - 1
    out = {}
    log(f"== phase 10c: scripts/eval_checkpoints_torch.py on {md} (2 clips, EVAL_BATCH 2, "
        f"tester.T={TOOLS_T})")
    t0 = time.time()
    with counted(fa, launches, "eval_checkpoints"), built_programs() as built:
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
            and launches["eval_checkpoints"] == per_fwd * (scores * len(rows)
                                                           + warmup_scores(built))):
        fail(f"eval_checkpoints: {ledger} launches {launches['eval_checkpoints']}")

    log(f"== phase 10d: scripts/eval_gap_sweep_torch.py on {ck4} (tester.T={TOOLS_T})")
    t0 = time.time()
    with counted(fa, launches, "eval_gap_sweep"), built_programs() as built:
        table = load_script("scripts/eval_gap_sweep_torch.py").run(ck4, synth, 2, TOOLS_OV,
                                                                    device="cuda")
    out["gap_sweep"] = {"rows": table["rows"], "wall_s": time.time() - t0}
    if not ([r[0] for r in table["rows"]] == [371, 743, 1486, 2962]
            and all(finite(*r) for r in table["rows"])
            and launches["eval_gap_sweep"] == per_fwd * (scores * 4 + warmup_scores(built))):
        fail(f"eval_gap_sweep: {table} launches {launches['eval_gap_sweep']}")
    return out


def phase_tools(torch, fa, np, work, card, gate, demos):
    """Phase 10b-10g in ``work``, after phase 8: phase 6e's model directory
    (``main``, its step-2 and step-4 checkpoints) is still there. ``gate``
    is 10a's (max_abs_err, record, launches); ``demos`` 10e's processes,
    started earlier (``start_demo``)."""
    log("== phase 10b-10g: the user tools on the card")
    t_phase = time.time()
    err, gate_rec, launches = gate
    launches, out = dict(launches), {"learning_gate": gate_rec}
    md = os.path.join(work, "main")
    ck4 = os.path.join(md, "22k_8s-4.pt")

    log("== phase 10b: scripts/make_synth_corpus_torch.py writes two 19 s test files")
    synth = os.path.join(work, "synth")
    load_script("scripts/make_synth_corpus_torch.py").write_corpus(synth, 0, 2, 19.0)
    out.update(tools_evals(fa, np, md, ck4, synth, launches))
    out["demo"] = join_demo(np, demos)

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


def start_demo(work, mode, ck4=None):
    """10e: examples/demo_inpainting_torch.py as a user runs it, in its own
    process: ``mode`` "time_gap" (a 1500 ms gap, phase 6e's step-4
    checkpoint ``ck4``) or "spectrogram" (a --spectrogram box, seeded
    weights). Returns {mode: (out dir, log, start time, process)}."""
    import subprocess
    here = os.path.dirname(os.path.abspath(__file__))
    d = os.path.join(work, f"demo_{mode}")
    extra = ["--gap-ms", "1500", "--checkpoint", ck4] if mode == "time_gap" else ["--spectrogram"]
    cmd = [sys.executable, os.path.join(here, "examples", "demo_inpainting_torch.py"),
           "--T", str(TOOLS_T), "--out", d, *extra]
    log(f"== phase 10e (started): {' '.join(cmd[1:])}")
    log_path = os.path.join(work, f"demo_{mode}.log")
    with open(log_path, "w") as out:
        p = subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT)
    return {mode: (d, log_path, time.time(), p)}


def join_demo(np, procs, timeout=900):
    """10e's checks: each demo (``start_demo``'s processes) exits 0; its
    files are finite; the time-gap demo's observed samples are bit-exact in
    the written files. No demo is left running."""
    import subprocess
    from aid_tpu_torch.data import audio_io
    res = {}
    try:
        for mode, (d, log_path, t0, p) in procs.items():
            try:
                p.wait(timeout=max(1.0, t0 + timeout - time.time()))
            except subprocess.TimeoutExpired:
                fail(f"the demo ({mode}) outlived {timeout} s")
            wall = time.time() - t0
            if p.returncode != 0:
                fail(f"the demo ({mode}) exited {p.returncode}:\n"
                     f"{open(log_path).read()[-6000:]}")
            sig = {n: audio_io.read(os.path.join(d, n + ".wav"))[0]
                   for n in ("original", "degraded", "reconstructed")}
            rec = {"wall_s_to_join": wall,
                   "finite": all(bool(np.isfinite(v).all()) for v in sig.values()),
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
    finally:
        for _, _, _, p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
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


# ----------------------------------------------------- the launchers (10h-10j)

# the config groups of scripts/testing_torch.sh and testing_shortgaps_torch.sh
# (tests/test_torch_launchers.py holds them to the JAX launchers'): this
# process composes them to know the masks and the sizes the launchers ran
LONG_GAP = ["dset=maestro_allyears", "exp=maestro22k_8s", "network=cqtdiff_plus_22k",
            "tester=inpainting_tester"]
SHORT_GAP = ["dset=inpainting_mask_dataset", "exp=musicnet44k_4s", "network=cqtdiff_plus_44k",
             "tester=inpainting_tester_shortgaps"]
LAUNCH_OV = []             # appended to every launcher run (a CPU rehearsal: a tiny net)
SHORT_GAPS_MS = 25         # four gaps a file in 10j's masks
LAUNCHED = []              # the launchers' processes, stopped by main() on any failure


class Beside:
    """``fn()`` in a thread beside this process's phases; ``join()`` returns
    its result or raises its failure."""

    def __init__(self, fn):
        import threading
        self.out, self.err = None, None

        def run():
            try:
                self.out = fn()
            except BaseException as e:        # a failed check is a SystemExit
                self.err = e

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()

    def join(self):
        self.thread.join()
        if self.err is not None:
            raise self.err
        return self.out


def stop(p, grace=30):
    """End a launcher's process and, under torch.distributed.run, its ranks
    (each in a process group of its own): SIGTERM, on which the agent stops its
    ranks, then SIGKILL for what is left."""
    import signal
    import subprocess
    if p.poll() is not None:
        return
    kids = []
    for d in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{d}/stat") as f:
                if int(f.read().rsplit(")", 1)[1].split()[1]) == p.pid:
                    kids.append(int(d))
        except (OSError, IndexError, ValueError):
            pass
    p.terminate()
    try:
        p.wait(timeout=grace)
    except subprocess.TimeoutExpired:
        p.kill()
        p.wait()
    for pid in kids:
        try:
            os.kill(pid, signal.SIGKILL)
        except ProcessLookupError:
            pass


def process(work, name, cmd, what, timeout=600, **knobs):
    """``cmd`` (run from the checkout's root) as a user runs it, ``knobs``
    in its environment and PYTHON this interpreter, its output in
    ``work/<name>.log``. Fails if it exits non-zero or outlives
    ``timeout``; returns (wall seconds, log path, output)."""
    import subprocess
    here = os.path.dirname(os.path.abspath(__file__))
    knobs = {k: str(v) for k, v in knobs.items()}
    # beside this process's work on the same card: expandable segments keep
    # each process's reserved memory near what it uses
    env = dict(os.environ, PYTHON=sys.executable,
               PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True", **knobs)
    log(f"== phase {name} (started): {' '.join(f'{k}={v}' for k, v in knobs.items())} "
        f"{what}")
    log_path = os.path.join(work, f"{name}.log")
    t0 = time.time()
    with open(log_path, "w") as out:
        p = subprocess.Popen(cmd, env=env, cwd=here, stdout=out, stderr=subprocess.STDOUT)
    LAUNCHED.append(p)
    try:
        p.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        log(f"{name}: {what} outlived {timeout} s")
    finally:
        stop(p)
    wall = time.time() - t0
    text = open(log_path).read()
    if p.returncode != 0:
        log(text[-8000:])
        fail(f"{name}: {what} exited {p.returncode}")
    return wall, log_path, text


def launcher(work, name, script, args, timeout=600, **knobs):
    """``scripts/<script> args`` as a user runs it, ``knobs`` (MODEL_DIR,
    CKPT, NPROC, ...) in its environment (``process``)."""
    here = os.path.dirname(os.path.abspath(__file__))
    return process(work, name, ["bash", os.path.join(here, "scripts", script), *args],
                   f"scripts/{script} {' '.join(args)}", timeout, **knobs)


def mode_seconds(text, mode):
    """The seconds the tester printed for ``mode`` (``[tester] mode: S s``)."""
    m = re.search(rf"^\[tester\] {mode}: ([\d.]+) s$", text, re.M)
    if not m:
        fail(f"no '[tester] {mode}: ... s' line")
    return float(m.group(1))


def check_inpainted(np, mode_dir, masks, hann):
    """An evaluation launcher's outputs in ``mode_dir``: every wav finite;
    for each file (``masks``: stem -> [L] mask, 0 in the gaps) the
    reconstruction equal to the original within one 16-bit step farther
    than ``hann`` from a gap, and non-zero in the gaps; every metrics.json
    finite."""
    from aid_tpu_torch.data import audio_io
    wavs = [os.path.join(d, f) for d, _, fs in os.walk(mode_dir) for f in fs if f.endswith(".wav")]
    finite_wavs = all(bool(np.isfinite(audio_io.read(w)[0]).all()) for w in wavs)
    files = {}
    for stem, mask in masks.items():
        orig, rec = (audio_io.read(os.path.join(mode_dir, sub, stem + ".wav"))[0]
                     for sub in ("original", "reconstructed"))
        gap = mask == 0
        near = np.convolve(gap.astype(np.float32), np.ones(2 * hann + 1), "same") > 0
        files[stem] = {"observed_max_abs_err": float(np.abs(rec[~near] - orig[~near]).max()),
                       "gap_rms": float(np.sqrt(np.mean(rec[gap] ** 2))),
                       "gap_samples": int(gap.sum())}
    ok = (finite_wavs and len(wavs) == 3 * len(masks) and check_metrics(mode_dir) == 1
          and all(f["observed_max_abs_err"] <= LSB and f["gap_rms"] > 0 for f in files.values()))
    return ok, {"wavs": len(wavs), "wavs_finite": finite_wavs, "files": files,
                "observed_tol": LSB, "hann_size": hann}


def newest_mode_dir(md, mode):
    runs = sorted(os.listdir(os.path.join(md, "test")))
    return os.path.join(md, "test", runs[-1], mode)


def launch_training(work, card):
    """10h: NPROC=2 scripts/training_torch.sh, two steps on phase 6e's corpus:
    two ranks share the card over gloo under torch.distributed.run."""
    corpus, md = os.path.join(work, "maestro"), os.path.join(work, "launch")
    wall, log_path, text = launcher(
        work, "10h", "training_torch.sh",
        train_overrides(corpus, md, "exp.batch=2", "exp.total_its=2", "logging.log_interval=1",
                        "logging.save_interval=2", "logging.heavy_log_interval=1000000",
                        *LAUNCH_OV),
        NPROC=2, MODEL_DIR=md, MASTER_PORT=free_port())
    # the ranks write to one file unbuffered (torch.distributed.run starts
    # them with -u), so a line of one rank can hold the end of another's:
    # the checks find their lines anywhere in the text
    lines = re.findall(r"\bit (\d+)\s+loss ([-+\d.eEnaif]+)\s+gnorm ([\d.naif]+)", text)
    rows, _ = load_script("scripts/train_report_torch.py").parse(log_path)
    said = [ln for ln in text.splitlines() if "[mesh]" in ln or "[setup]" in ln]
    rec = {"check": "launcher", "phase": "10h", "script": "scripts/training_torch.sh",
           "knobs": {"NPROC": 2}, "wall_s": wall, "it_loss_gnorm": lines,
           "train_report_rows": [[r[0], r[1]] for r in rows],
           "checkpoint": os.path.exists(os.path.join(md, "22k_8s-2.pt")), "ranks_said": said,
           "card": card}
    log(json.dumps(rec))
    if not (rec["checkpoint"] and [int(i) for i, _, _ in lines] == [1, 2]
            and all(finite(loss, g) for _, loss, g in lines)
            and rows and {(r[0], r[1]) for r in rows} <= {(int(i), float(x)) for i, x, _ in lines}
            and text.count("backend gloo") == 2 and text.count("shared-card mode") == 2):
        fail(f"10h, the training launcher: {rec}")
    return md, rec


def launch_long_gap(np, work, md, card):
    """10i: scripts/testing_torch.sh with CKPT empty in 10h's MODEL_DIR: the
    latest-checkpoint scan loads 10h's step-2 checkpoint."""
    from types import SimpleNamespace
    from aid_tpu_torch.testing.tester import Tester
    from aid_tpu_torch.utils.config import compose
    corpus = os.path.join(work, "maestro")
    wall, _, text = launcher(work, "10i", "testing_torch.sh",
                             [f"dset.path={corpus}", f"tester.T={TOOLS_T}", *LAUNCH_OV],
                             MODEL_DIR=md, CKPT="")
    args = compose(overrides=[*LONG_GAP, *LAUNCH_OV])
    L, fs = int(args.exp.audio_len), int(args.exp.sample_rate)
    mask = Tester.prepare_mask(SimpleNamespace(t=args.tester, audio_len=L, fs=fs))[0]
    ok, files = check_inpainted(np, newest_mode_dir(md, "inpainting"), {"test_piece": mask},
                                int(args.tester.data_consistency.hann_size))
    seconds = mode_seconds(text, "inpainting")
    rec = {"check": "launcher", "phase": "10i", "script": "scripts/testing_torch.sh",
           "knobs": {"CKPT": ""}, "wall_s": wall, "T": TOOLS_T,
           "no_checkpoint_warning": "no checkpoint found" in text,
           "inpainting_s": seconds, "inpainting_rtf": L / fs / seconds, **files, "card": card}
    log(json.dumps(rec))
    if not ok or rec["no_checkpoint_warning"]:
        fail(f"10i, the long-gap launcher: {rec}")
    return rec


def launch_short_gap(np, work, card):
    """10j: scripts/testing_shortgaps_torch.sh with an explicit CKPT (a
    reference-layout .pt of the 44.1 kHz flagship on phase 5b's seeded
    weights) on two 44.1 kHz files, each with a mask of four 25 ms gaps."""
    from aid_tpu_torch import setup as tsetup
    from aid_tpu_torch.data import audio_io
    from aid_tpu_torch.models.unet_cqt import MAIN_SCALE
    from aid_tpu_torch.utils import checkpoint_torch
    from aid_tpu_torch.utils.config import compose
    d = os.path.join(work, "shortgaps")
    args = compose(overrides=[*SHORT_GAP, *LAUNCH_OV])
    L, fs = int(args.exp.audio_len), int(args.exp.sample_rate)
    gap = int(SHORT_GAPS_MS / 1000 * fs)
    masks = {}
    for sub in ("audio", "masks"):
        os.makedirs(os.path.join(d, sub), exist_ok=True)
    for i in range(2):
        stem = f"clip_{i}"
        audio_io.write(os.path.join(d, "audio", stem + ".wav"), music(np, L + fs // 10, fs, 40 + i),
                       fs)
        mask = np.ones(L, np.float32)
        for f in (0.2, 0.4, 0.6, 0.8):
            s = int(f * L) + 997 * i
            mask[s:s + gap] = 0.0
        np.save(os.path.join(d, "masks", stem + ".npy"), mask)
        masks[stem] = mask
    # phase 5b's weights: the network as from_config builds it, then
    # init_weights(0, MAIN_SCALE) (a CPU generator: the same on any device)
    net = tsetup.setup_network(args, device="cpu").init_weights(0, gate_scale=MAIN_SCALE)
    pt = checkpoint_torch.export_checkpoint(os.path.join(d, "musicnet44k_seeded.pt"), net)
    del net
    md = os.path.join(d, "md")
    wall, _, text = launcher(
        work, "10j", "testing_shortgaps_torch.sh",
        [f"tester.T={TOOLS_T}", f"dset.test.path={os.path.join(d, 'audio')}",
         f"dset.test.mask_path={os.path.join(d, 'masks')}", "dset.test.num_samples=2",
         *LAUNCH_OV], MODEL_DIR=md, CKPT=pt)
    ok, files = check_inpainted(np, newest_mode_dir(md, "inpainting_shortgaps"), masks,
                                int(args.tester.data_consistency.hann_size))
    seconds = mode_seconds(text, "inpainting_shortgaps")
    rec = {"check": "launcher", "phase": "10j", "script": "scripts/testing_shortgaps_torch.sh",
           "knobs": {"CKPT": os.path.basename(pt)}, "wall_s": wall, "T": TOOLS_T,
           "no_checkpoint_warning": "no checkpoint found" in text,
           "inpainting_shortgaps_s": seconds,
           "inpainting_shortgaps_rtf": len(masks) * L / fs / seconds, **files, "card": card}
    log(json.dumps(rec))
    if not ok or rec["no_checkpoint_warning"]:
        fail(f"10j, the short-gap launcher: {rec}")
    return rec


def phase_launchers(np, work, card):
    """10h-10j in ``work`` (phase 6e's corpus is there), each launcher a
    process of its own beside this process's phases; returns their
    records."""
    t0 = time.time()
    md, train = launch_training(work, card)
    out = {"10h": train, "10i": launch_long_gap(np, work, md, card),
           "10j": launch_short_gap(np, work, card)}
    PHASE_S["10h-j"] = time.time() - t0
    return out


# ------------------------------------------------------------------- phase 11
BENCH_CUT = "tester.T=4"       # 11a's full suite and 11b: the plumbing, at a cut depth
HEADLINE_SCORES = 69           # denoiser calls of a T=35, order 2 trajectory
TRAIN_BENCH_STEPS = 3


def bench_run(work, name, ranks=0, timeout=600, **knobs):
    """``python bench_torch.py`` with ``knobs`` (under torch.distributed.run
    with ``ranks`` ranks when above 0); returns (wall seconds, its detail
    lines by leg, its result lines, the output)."""
    cmd = ["bench_torch.py"]
    if ranks:
        cmd = ["-m", "torch.distributed.run", "--nproc-per-node", str(ranks), "--master-port",
               str(free_port()), *cmd]
    wall, _, text = process(work, name, [sys.executable, *cmd], f"python {' '.join(cmd)}",
                            timeout, **knobs)
    rows = []
    for ln in text.splitlines():
        if ln.startswith("{"):
            try:
                rows.append(json.loads(ln))
            except ValueError:
                pass
    return (wall, {r["leg"]: r for r in rows if "leg" in r},
            [r for r in rows if "metric" in r], text)


def bench_record(phase, wall, legs, lines, card, **knobs):
    rec = {"check": "bench", "phase": phase, "knobs": knobs, "wall_s": wall,
           "line": lines[-1] if lines else None,
           "legs": {k: {f: v[f] for f in ("batch", "rows_per_rank", "T", "scores_per_trajectory",
                                          "rep_s", "finite", "capture_s", "memory_bytes")}
                    for k, v in legs.items()}, "card": card}
    log(json.dumps(rec))
    return rec


def phase_bench_alone(work, card):
    """11a: ``bench_torch.py``'s headline at full width and depth (22 kHz,
    bf16, BENCH_BATCH 2, T=35), then its full suite at T=4 (the plumbing of
    every leg), each in its own process with nothing else on the card."""
    wall, legs, lines, _ = bench_run(work, "11a_headline", BENCH_SUITE="headline",
                                     BENCH_REPS=1)
    head = bench_record("11a", wall, legs, lines, card, BENCH_SUITE="headline", BENCH_REPS=1)
    h = legs.get("headline", {})
    if not (len(lines) == 1 and finite(lines[0]["value"]) and lines[0]["value"] > 0
            and h.get("scores_per_trajectory") == HEADLINE_SCORES and h.get("batch") == 2
            and h.get("T") == 35 and h.get("finite")):
        fail(f"11a, the bench's headline: {head}")
    wall, legs, lines, _ = bench_run(work, "11a_full", BENCH_SUITE="full", BENCH_REPS=1,
                                     BENCH_OVERRIDES=BENCH_CUT)
    full = bench_record("11a", wall, legs, lines, card, BENCH_SUITE="full", BENCH_REPS=1,
                        BENCH_OVERRIDES=BENCH_CUT)
    ex = (lines[-1].get("extras", {}) if lines else {})
    if not (set(ex) == {"shortgaps_rtf", "uncond_rtf", "rtf_44k"}
            and all(finite(v) and v > 0 for v in ex.values())
            and sorted(legs) == ["44k", "headline", "shortgaps", "uncond"]
            and all(v["finite"] for v in legs.values())):
        fail(f"11a, the bench's full suite: {full}")
    return {"headline": head, "full": full}


def phase_bench_train(work, card):
    """11c: ``scripts/bench_train_torch.py`` at the flagship (batch 4, f32,
    remat, TF32 convs as the training default), TRAIN_BENCH_STEPS steps,
    alone on the card."""
    wall, _, text = process(work, "11c", [sys.executable, "scripts/bench_train_torch.py",
                                          "network.compute_dtype=float32"],
                            "scripts/bench_train_torch.py network.compute_dtype=float32",
                            TRAIN_BENCH_STEPS=TRAIN_BENCH_STEPS)
    first = re.search(r"^first step \(capture\): ([\d.]+)s$", text, re.M)
    step = re.search(r"^train step: ([\d.a-z]+) ms  \(global batch (\d+), ([\d.]+) s "
                     r"audio/step -> ([\d.a-z]+)x realtime\)$", text, re.M)
    rec = {"check": "bench_train", "phase": "11c", "wall_s": wall,
           "steps": TRAIN_BENCH_STEPS, "first_step_s": first and float(first.group(1)),
           "step_ms": step and float(step.group(1)),
           "global_batch": step and int(step.group(2)),
           "x_realtime": step and float(step.group(4)), "card": card}
    log(json.dumps(rec))
    if not (first and step and finite(rec["step_ms"]) and rec["step_ms"] > 0
            and rec["global_batch"] == TRAIN_BATCH):
        fail(f"11c, the training bench: {rec}")
    return rec


def phase_bench_dp(work, card):
    """11b, beside this process's phases: the bench's dp mode at two ranks
    sharing the card over gloo (the headline at T=4: arithmetic, not
    scaling)."""
    t0 = time.time()
    wall, legs, lines, text = bench_run(work, "11b", ranks=2, BENCH_DEVICES=2,
                                        BENCH_SUITE="headline", BENCH_REPS=1,
                                        BENCH_OVERRIDES=BENCH_CUT)
    dp = bench_record("11b", wall, legs, lines, card, BENCH_DEVICES=2, BENCH_SUITE="headline",
                      BENCH_REPS=1, BENCH_OVERRIDES=BENCH_CUT)
    if not (len(lines) == 1 and lines[0].get("devices") == 2 and finite(lines[0]["value"])
            and lines[0]["value"] > 0 and text.count("backend gloo") == 2
            and legs.get("headline", {}).get("finite")):
        fail(f"11b, the bench's dp mode: {dp}")
    PHASE_S["11b"] = time.time() - t0
    return dp


def phase_bench_loader(work, card):
    """11d, host only: the loader's bench."""
    t0 = time.time()
    args = ["--files", "4", "--secs", "30", "--batches", "10"]
    wall, _, text = process(work, "11d", [sys.executable, "scripts/bench_loader_torch.py",
                                          *args],
                            f"scripts/bench_loader_torch.py {' '.join(args)}")
    rows = re.findall(r"^num_workers=(\d):\s+([\d.]+) batches/s\s+([\d.]+) segments/s\s+"
                      r"([\d.]+)x budget  \[(OK|BOTTLENECK)\]$", text, re.M)
    loader = {"check": "bench_loader", "phase": "11d", "wall_s": wall, "args": args,
              "rows": [{"num_workers": int(r[0]), "batches_per_s": float(r[1]),
                        "segments_per_s": float(r[2]), "x_budget": float(r[3]),
                        "verdict": r[4]} for r in rows], "card": card}
    log(json.dumps(loader))
    if [r[0] for r in rows] != ["0", "2", "4"]:
        fail(f"11d, the loader bench: {loader}")
    PHASE_S["11d"] = time.time() - t0
    return loader


# ------------------------------------------------------------------ DiffWave

DW_NET = ["network=diffwave_16k", "exp=librispeech16k_8s"]
DW_SHAPE = (2, 256, 131072)    # the served rows x DiffWave's C x 8.19 s at 16 kHz
DW_LAYERS = 36


def dw_weights(torch, net, seed):
    """Every parameter of ``net`` uniform in +-1/sqrt(fan in), biases too
    (lmnt's init zeroes the output projection, which would cut the
    guidance's gradient off the net)."""
    gen = torch.Generator().manual_seed(seed)
    return {n: (torch.rand(p.shape, generator=gen) * 2 - 1)
            / math.sqrt(p[0].numel() if p.dim() >= 2 else p.numel())
            for n, p in sorted(net.state_dict().items())}


def dw_gate(torch, gt, card):
    """(a) the gate kernels against the plain version at the served shape, in
    bf16 and f32, forward and backward; (b) their device time against the
    plain version's and the bytes bound, per guided score (36 forward and 36
    backward launches), inputs not in L2."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    B, C, L = DW_SHAPE
    out, bad = {}, []
    for dt in (torch.float32, torch.bfloat16):
        z = (3.0 * torch.randn(B, 2 * C, L, generator=gen, device="cuda")).to(dt)
        dg = torch.randn(B, C, L, generator=gen, device="cuda").to(dt)
        g, dz = gt._gated_cuda(z), gt._gated_bwd_cuda(z, dg)
        gp, dzp = gt.gated_tanh_plain(z), gt.gated_tanh_bwd_plain(z, dg)
        err = (g.float() - gp.float()).abs().max().item()
        derr = ((dz.float() - dzp.float()).abs().max() / dzp.float().abs().max()).item()
        tol = 1e-6 if dt == torch.float32 else 2.0 ** -8
        log(json.dumps({"check": "gated_tanh", "dtype": str(dt)[6:], "shape": [B, 2 * C, L],
                        "fwd_max_abs_err": err, "bwd_rel_err": derr, "tol": tol}))
        if not (err <= tol and derr <= tol):
            bad.append(f"gated_tanh {dt}: {err}, {derr}")
        out[str(dt)[6:]] = {"fwd_max_abs_err": err, "bwd_rel_err": derr}
        del z, dg, g, dz, gp, dzp
    dt = torch.bfloat16
    sets = [((3.0 * torch.randn(B, 2 * C, L, generator=gen, device="cuda")).to(dt),
             torch.randn(B, C, L, generator=gen, device="cuda").to(dt)) for _ in range(2)]
    with torch.no_grad():
        fwd = graph_ms(torch, lambda z, g: gt._gated_cuda(z), sets, reps=8)
        bwd = graph_ms(torch, gt._gated_bwd_cuda, sets, reps=8)
        fwd_p = graph_ms(torch, lambda z, g: gt.gated_tanh_plain(z), sets, reps=4)
        bwd_p = graph_ms(torch, gt.gated_tanh_bwd_plain, sets, reps=4)
    del sets
    torch.cuda.empty_cache()
    n = B * C * L * 2
    t = {"fwd_ms": DW_LAYERS * fwd, "fwd_plain_ms": DW_LAYERS * fwd_p,
         "fwd_bound_ms": DW_LAYERS * 3 * n / HBM_BYTES_PER_S * 1e3,
         "bwd_ms": DW_LAYERS * bwd, "bwd_plain_ms": DW_LAYERS * bwd_p,
         "bwd_bound_ms": DW_LAYERS * 5 * n / HBM_BYTES_PER_S * 1e3}
    t["fwd_roofline_pct"] = 100 * t["fwd_bound_ms"] / t["fwd_ms"]
    t["bwd_roofline_pct"] = 100 * t["bwd_bound_ms"] / t["bwd_ms"]
    log(json.dumps({"timing": "gated_tanh per 2-row guided score (36 launches each way), bf16",
                    **t, "card": card}))
    return {**out, **t}, bad


def dw_conv_rows(torch, dw, card, B, dt, weight_grad):
    """The dilated k=3 conv C -> 2C over [B, C, 131072] in ``dt`` at every
    dilation of the net: cuDNN's dilated conv1d against the folded form,
    forward and forward plus the input gradient (with ``weight_grad`` the
    weight's too), each a CUDA graph over inputs not in L2."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    _, C, L = DW_SHAPE
    xs = [(torch.randn(B, C, L, generator=gen, device="cuda").to(dt),) for _ in range(2)]
    w = (torch.randn(2 * C, C, 3, generator=gen, device="cuda") / math.sqrt(3 * C)).to(dt)
    b = torch.zeros(2 * C, device="cuda", dtype=dt)
    gy = torch.randn(B, 2 * C, L, generator=gen, device="cuda").to(dt)
    what = f"dilated conv C->2C, [{B}, {C}, {L}] {str(dt)[6:]}" + \
        (" (TF32), backward with the weight gradient" if weight_grad else "")
    rows = []
    for d in [2 ** i for i in range(12)]:
        row = {"d": d}
        for form in dw.CONV_FORMS:
            def fwd(x, form=form):
                return dw.dilated_conv1d(x, w, b, d, form)

            def fwd_bwd(x, form=form):
                xg = x.detach().requires_grad_(True)
                wg = w.detach().requires_grad_(weight_grad)
                wrt = (xg, wg) if weight_grad else (xg,)
                return torch.autograd.grad(dw.dilated_conv1d(xg, wg, b, d, form), wrt, gy)

            with torch.no_grad():
                row[f"{form}_ms"] = graph_ms(torch, fwd, xs, reps=6)
            row[f"{form}_fwd_bwd_ms"] = graph_ms(torch, fwd_bwd, xs, reps=6)
            torch.cuda.empty_cache()
        rows.append(row)
        log(json.dumps({"timing": what, **row, "card": card}))
    del xs, gy
    torch.cuda.empty_cache()
    return rows


def dw_convs(torch, F, dw, card):
    """(c) The dilated conv's two forms at every dilation: at the served
    shape in bf16 with the input gradient (the guided score), and at the
    training batch 4 in f32 with TF32 convs and both gradients (the
    training step); the 1x1 conv C -> 2C as a conv1d against a matmul."""
    rows = dw_conv_rows(torch, dw, card, DW_SHAPE[0], torch.bfloat16, weight_grad=False)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        rows_f32 = dw_conv_rows(torch, dw, card, 4, torch.float32, weight_grad=True)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    gen = torch.Generator(device="cuda").manual_seed(12)
    B, C, L = DW_SHAPE
    dt = torch.bfloat16
    xs = [(torch.randn(B, C, L, generator=gen, device="cuda").to(dt),) for _ in range(2)]
    b = torch.zeros(2 * C, device="cuda", dtype=dt)
    w1 = (torch.randn(2 * C, C, 1, generator=gen, device="cuda") / math.sqrt(C)).to(dt)
    with torch.no_grad():
        conv1 = graph_ms(torch, lambda x: F.conv1d(x, w1, b), xs, reps=6)
        mm = graph_ms(torch, lambda x: torch.matmul(w1[:, :, 0], x) + b[:, None], xs, reps=6)
    log(json.dumps({"timing": "1x1 conv C->2C, [2, 256, 131072] bf16", "conv1d_ms": conv1,
                    "matmul_ms": mm, "card": card}))
    del xs
    torch.cuda.empty_cache()
    return {"dilated": rows, "dilated_f32": rows_f32, "conv1x1_ms": conv1, "matmul_ms": mm}


def dw_score(torch, np, dw, ref, card):
    """The guided score at the served shape: the port's bf16 net (the gate
    kernels, the dilated-conv form the net takes) against the float32
    reference on the same weights (TF32 off): the denoised estimate and the
    guidance's input gradient; device time and peak memory of the score."""
    from aid_tpu_torch.diffusion import edm
    from aid_tpu_torch.ops import gated_tanh as gt
    from aid_tpu_torch.utils.config import compose
    args = compose(overrides=DW_NET)
    state = dw_weights(torch, dw.build_diffwave(args), 13)
    net = dw.build_diffwave(args)
    net.load_state_dict(state)
    net = net.store_weights_in_compute_dtype().requires_grad_(False).cuda().eval()
    reference = ref.DiffWave()
    reference.load_state_dict(state)
    reference = reference.requires_grad_(False).cuda().eval()
    p = edm.EDMParams.from_args(args.tester.diff_params)
    B, _, L = DW_SHAPE
    rng = np.random.default_rng(14)
    x = torch.from_numpy((0.3 * rng.standard_normal((B, L))).astype(np.float32)).cuda()
    y = torch.from_numpy((0.05 * rng.standard_normal((B, L))).astype(np.float32)).cuda()
    mask = torch.ones(B, L, device="cuda")
    mask[:, L // 2 - 8000:L // 2 + 8000] = 0.0
    sigma = torch.tensor([[0.5], [0.2]], device="cuda")

    def score(model):
        xg = x.clone().requires_grad_(True)
        d = edm.denoiser(p, model, xg, sigma)
        r = (y - mask * d).reshape(B, -1)
        (g,) = torch.autograd.grad(r.square().sum(-1).sqrt().sum(), xg)
        return d.detach(), g

    out = {}
    for name, model in (("port", net), ("reference", reference)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        f0, b0 = gt.LAUNCHES.count(), gt.LAUNCHES.count(bwd=True)
        d, g = score(model)
        launches = (gt.LAUNCHES.count() - f0, gt.LAUNCHES.count(bwd=True) - b0)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        a, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(3):
            score(model)
        e.record()
        torch.cuda.synchronize()
        out[name] = {"d": d, "g": g, "ms": a.elapsed_time(e) / 3, "peak_gb": peak / 2 ** 30,
                     "launches": launches}
    P, R = out["port"], out["reference"]
    errs = {"d_max_rel_err": ((P["d"] - R["d"]).abs().max() / R["d"].abs().max()).item(),
            "d_gap_rel_l2": ((P["d"] - R["d"]) * (1 - mask)).norm().item()
            / (R["d"] * (1 - mask)).norm().item(),
            "grad_rel_l2": ((P["g"] - R["g"]).norm() / R["g"].norm()).item()}
    res = {**errs, "port_score_ms": P["ms"], "reference_score_ms": R["ms"],
           "port_peak_gb": P["peak_gb"], "reference_peak_gb": R["peak_gb"],
           "gate_launches": P["launches"], "card": card}
    log(json.dumps({"check": "diffwave guided score, [2, 131072], bf16 port vs f32 reference",
                    **res}))
    bad = []
    if not errs["d_max_rel_err"] <= BF16_TOL or not errs["grad_rel_l2"] <= 0.05:
        bad.append(f"diffwave score off the f32 reference: {errs}")
    if P["launches"] != (DW_LAYERS, DW_LAYERS):
        bad.append(f"gate launches a guided score {P['launches']}, expected 36 each way")
    del net, reference, out, P, R
    gc.collect()
    torch.cuda.empty_cache()
    return res, bad


def dw_train(torch, np, work, card, dw, fold_from):
    """One captured f32 training step at the published batch 4 with remat
    (TF32 convs, the training default), its dilated convs in the forms
    ``fold_from`` gives (as ``models.diffwave.FOLD_FROM``): build, the step
    replayed, its wall, peak memory, the program's memory and gate launches
    a step."""
    from aid_tpu_torch import setup as tsetup
    from aid_tpu_torch import train as ttrain
    from aid_tpu_torch.ops import gated_tanh as gt
    args = ttrain.compose_args(DW_NET + [f"model_dir={work}/diffwave_train",
                                         "logging.print_model_summary=False"])
    tf32, kept = torch.backends.cudnn.allow_tf32, dw.FOLD_FROM
    torch.backends.cudnn.allow_tf32 = True
    dw.FOLD_FROM = fold_from
    try:
        torch.cuda.reset_peak_memory_stats()
        net = tsetup.setup_network(args, device="cuda", seed=15, trainable=True)
        tr = tsetup.setup_trainer(args, network=net,
                                  diff_params=tsetup.setup_diff_parameters(args))
        tr.init_state()
        rng = np.random.default_rng(16)
        B, L = int(args.exp.batch), int(args.exp.audio_len)
        batches = [(0.05 * rng.standard_normal((B, L))).astype(np.float32) for _ in range(4)]
        fs = np.full(B, int(args.exp.sample_rate))
        t0 = time.time()
        prog = tr.compile_step(batches[0], fs)
        build_s = time.time() - t0
        losses, walls = [], []
        g0 = gt.LAUNCHES.count()
        for xb in batches:
            torch.cuda.synchronize()
            t = time.perf_counter()
            m = tr.train_step(xb, fs)
            losses.append(float(m["loss"]))
            walls.append(time.perf_counter() - t)
        res = {"batch": B, "remat": bool(net.remat), "fold_from": str(fold_from),
               "build_s": build_s,
               "step_ms": 1e3 * float(np.median(walls[1:])), "losses": losses,
               "gate_launches_per_step": (gt.LAUNCHES.count() - g0) / len(batches),
               "program_memory_gb": prog.memory_bytes() / 2 ** 30,
               "peak_reserved_gb": torch.cuda.max_memory_reserved() / 2 ** 30, "card": card}
    finally:
        torch.backends.cudnn.allow_tf32, dw.FOLD_FROM = tf32, kept
    log(json.dumps({"check": "diffwave training step, f32, batch 4, remat, captured", **res}))
    bad = [] if all(math.isfinite(v) for v in losses) else [f"diffwave losses {losses}"]
    del tr, net, prog
    gc.collect()
    torch.cuda.empty_cache()
    return res, bad


def dw_serve(torch, np, card):
    """``InpaintingService.from_config(DW_NET)`` (bf16, T=35, guided, seeded
    lmnt-init weights) answers a 20 s request with two gaps through its
    captured programs under the profiler: observed samples exact, the gate
    kernels in the trace and their counters non-zero, the real-time factor."""
    from aid_tpu_torch.serving import InpaintingService
    from aid_tpu_torch.utils import trace
    svc = InpaintingService.from_config(DW_NET, seed=17)
    svc.precompile()
    fs, n = 16000, 20 * 16000
    rng = np.random.default_rng(18)
    audio = (0.05 * rng.standard_normal(n)).astype(np.float32)
    mask = np.ones(n, np.float32)
    mask[5 * fs:5 * fs + 8000] = mask[15 * fs:15 * fs + 4000] = 0.0
    c0 = trace.snapshot()["counters"]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        out = svc.inpaint(audio, mask, fs, seed=19)
        wall = time.perf_counter() - t
    c1 = trace.snapshot()["counters"]
    names = {e.key for e in prof.key_averages()}
    res = {"wall_s": wall, "rtf": 2 * svc.args.exp.audio_len / fs / wall,
           "observed_changed": int(np.count_nonzero((mask > 0) & (out != audio))),
           "gate_launches": c1["gated_tanh.launches"] - c0["gated_tanh.launches"],
           "gate_bwd_launches": c1["gated_tanh.bwd_launches"] - c0["gated_tanh.bwd_launches"],
           "kernels_in_trace": sorted(k for k in names if "gated_tanh" in k),
           "programs": [p.report() for p in svc.sampler._programs.values()], "card": card}
    log(json.dumps({"check": "diffwave InpaintingService request", **res}))
    bad = []
    if res["observed_changed"] or not np.isfinite(out).all():
        bad.append("diffwave service changed observed samples or returned non-finite ones")
    if not (res["gate_launches"] and res["gate_bwd_launches"]) or \
            not {"_gated_tanh_fwd", "_gated_tanh_bwd"} <= set(res["kernels_in_trace"]):
        bad.append(f"diffwave service did not run the gate kernels: {res['kernels_in_trace']}")
    del svc
    gc.collect()
    torch.cuda.empty_cache()
    return res, bad


def phase_diffwave(torch, np, work, card):
    """Phase 12: DiffWave (network=diffwave_16k, exp=librispeech16k_8s) on
    the card: (a-b) the gate kernels, (c) the dilated-conv forms, (d) the
    guided score against the f32 reference, (e) a captured training step in
    the net's conv forms and with f32 convs folded from d = 16, (f) a
    served request. Fails after every part has logged."""
    import torch.nn.functional as F

    from aid_tpu_torch.models import diffwave as dw
    from aid_tpu_torch.ops import gated_tanh as gt
    from tests import diffwave_reference as ref
    log("== phase 12: DiffWave, unconditional (network=diffwave_16k, exp=librispeech16k_8s)")
    out, bad = {}, []
    for name, fn in (("gate", lambda: dw_gate(torch, gt, card)),
                     ("convs", lambda: (dw_convs(torch, F, dw, card), [])),
                     ("score", lambda: dw_score(torch, np, dw, ref, card)),
                     ("train", lambda: dw_train(torch, np, work, card, dw, dw.FOLD_FROM)),
                     ("train_folded", lambda: dw_train(torch, np, work, card, dw,
                                                       {torch.float32: 16})),
                     ("serve", lambda: dw_serve(torch, np, card))):
        with phase_time(f"12-{name}"):
            out[name], b = fn()
            bad += b
    if bad:
        fail("; ".join(bad))
    return out


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

    with phase_time("2"):
        worst = phase_kernel(torch, fa, batches)
    with phase_time("3"):
        shapes = phase_denoiser(torch, fa, serve_batch)

    log(f"== phase 4: kernel at every launch shape, checked at batch {batches}; "
        "timed per batch row over one flagship denoiser call (bf16, tanh: the "
        "served configuration)")
    with phase_time("4"):
        timing = time_kernel(torch, fa, shapes, "tanh", torch.bfloat16, batches)
    log(json.dumps({"timing": "fused_adaln_fwd per denoiser call", **timing,
                    "card": card}))
    log("library_ms: null -- no single PyTorch call computes gelu(x * inv * mod)")
    log(f"== phase 4, backward: the backward kernel at every launch shape at batch "
        f"{serve_batch} (the served rows), bf16, tanh, per differentiated denoiser call")
    with phase_time("4-bwd"):
        timing_bwd = time_kernel_bwd(torch, fa, shapes, "tanh", torch.bfloat16, serve_batch)
    log(json.dumps({"timing": "fused_adaln_bwd per guided score", **timing_bwd,
                    "card": card}))

    with phase_time("3b"):
        phase_options(torch, fa, card)
    with phase_time("5"):
        launches, rtf, answers, programs_22k = phase_serving(torch, fa, np, batches, card)
    request_b = answers["b_four_25ms_gaps"]
    log(json.dumps({"inpaint_rtf_request_a": rtf, "programs_22k": programs_22k, "card": card}))
    work = os.path.join(here, "experiments", "chip_smoke_training")
    shutil.rmtree(work, ignore_errors=True)
    demos = {}      # 10e's processes: started early, checked in phase 10
    try:
        os.makedirs(work)
        with phase_time("5b"):
            launches_44k, timing_44k, serving_44k = phase_serving_44k(torch, fa, np, work,
                                                                      card)
        log(json.dumps({"serving_44k": serving_44k, "card": card}))
        with phase_time("6"):
            train_launches, train_err = phase_training(torch, fa, np, work, card, shapes)

        # the time-gap demo's process runs beside phase 7
        demos.update(start_demo(work, "time_gap", os.path.join(work, "main", "22k_8s-4.pt")))

        def learning():                  # 10a, beside phase 7's training steps
            with phase_time("10a"):
                log("== phase 10: the port learns; the user tools on the card")
                launches = {}
                err, rec = phase_learning(torch, fa, np, work, card, launches)
            return err, rec, launches

        def evaluation_ab():             # 8a-8b, beside phase 7's ranks
            with phase_time("8a-b"):
                return phase_testing_ab(torch, fa, np, work, card)

        with phase_time("7-10a-8ab"):
            parallel_launches, parallel_err, gate, testing_ab = phase_parallel(
                torch, fa, np, work, card, answers["a_centre_gap_1500ms"], request_b,
                beside_steps=learning, beside_scores=evaluation_ab)
        demos.update(start_demo(work, "spectrogram"))    # beside 8c-8d and 10b-10d
        # 10h-10j: the shell launchers, one process after another, beside
        # 8c-8d and 10b-10g
        # then 11b, the bench's dp mode
        launchers = Beside(lambda: (phase_launchers(np, work, card),
                                    {"11b": phase_bench_dp(work, card)}))
        with phase_time("8c-d"):
            test_launches, testing = phase_testing_c(torch, fa, np, work, card, testing_ab)
        with phase_time("10b-g"):
            tools_launches, tools_err = phase_tools(torch, fa, np, work, card, gate, demos)
        with phase_time("10h-j wait"):
            launched, benches = launchers.join()
        # 11a and 11c: the benches alone on the card; 11d (host only)
        # beside them
        loader = Beside(lambda: phase_bench_loader(work, card))
        with phase_time("11a"):
            benches.update(phase_bench_alone(work, card))
        with phase_time("11c"):
            benches["11c"] = phase_bench_train(work, card)
        benches["11d"] = loader.join()
        diffwave = phase_diffwave(torch, np, work, card)
    finally:
        for _, _, _, p in demos.values():          # none outlives the script
            if p.poll() is None:
                p.kill()
                p.wait()
        for p in LAUNCHED:
            stop(p)
        shutil.rmtree(work, ignore_errors=True)
    log(json.dumps({"launchers": {k: {f: v[f] for f in v if f.endswith(("_s", "_rtf"))}
                                  for k, v in launched.items()}, "card": card}))
    log(json.dumps({"benches": {
        "headline_rtf": benches["headline"]["line"]["value"],
        "full_suite_T4": benches["full"]["line"],
        "dp2_T4": benches["11b"]["line"], "train_step_ms": benches["11c"]["step_ms"],
        "loader_segments_per_s": [r["segments_per_s"] for r in benches["11d"]["rows"]],
        "walls_s": {"11a_headline": benches["headline"]["wall_s"],
                    "11a_full": benches["full"]["wall_s"], "11b": benches["11b"]["wall_s"],
                    "11c": benches["11c"]["wall_s"], "11d": benches["11d"]["wall_s"]}},
        "card": card}))
    log(json.dumps({"testing": {**testing, "card": card}}))
    log(json.dumps({"launches_by_path": {"serving": launches, "serving_44k": launches_44k,
                                         "training": train_launches,
                                         "parallel": parallel_launches,
                                         "testing": test_launches,
                                         "tools": tools_launches}}))
    log(json.dumps({"phase_seconds": PHASE_S, "total_s": time.time() - t_start,
                    "card": card}))

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
                "library_ms": None},
               {"name": "fused_adaln_bwd", "route": "triton",
                "source": "aid_tpu_torch/ops/fused_adaln.py", "replaces": None,
                "max_dx_ulps": timing_bwd["kernel_dx_ulps"],
                "ms": timing_bwd["ms"], "plain_ms": timing_bwd["plain_ms"],
                "bound_ms": timing_bwd["bound_ms"], "bound_by": "bytes",
                "library_ms": None},
               {"name": "gated_tanh_fwd", "route": "triton",
                "source": "aid_tpu_torch/ops/gated_tanh.py", "replaces": None,
                "max_abs_err": diffwave["gate"]["bfloat16"]["fwd_max_abs_err"],
                "ms": diffwave["gate"]["fwd_ms"], "plain_ms": diffwave["gate"]["fwd_plain_ms"],
                "bound_ms": diffwave["gate"]["fwd_bound_ms"], "bound_by": "bytes",
                "library_ms": None},
               {"name": "gated_tanh_bwd", "route": "triton",
                "source": "aid_tpu_torch/ops/gated_tanh.py", "replaces": None,
                "max_rel_err": diffwave["gate"]["bfloat16"]["bwd_rel_err"],
                "ms": diffwave["gate"]["bwd_ms"], "plain_ms": diffwave["gate"]["bwd_plain_ms"],
                "bound_ms": diffwave["gate"]["bwd_bound_ms"], "bound_by": "bytes",
                "library_ms": None}]
    log(f"total {time.time() - t_start:.1f} s")
    log(f"gpu: {card}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


def diffwave_main():
    """``--diffwave``: phases 1 and 12 alone."""
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on an NVIDIA GPU")
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(here, ".triton_cache"))
    from aid_tpu_torch.tools.profile_denoiser import gpu_line
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_line()
    log("== phase 1: device")
    log(f"gpu: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    work = os.path.join(here, "experiments", "chip_smoke_diffwave")
    shutil.rmtree(work, ignore_errors=True)
    try:
        os.makedirs(work)
        phase_diffwave(torch, np, work, card)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(json.dumps({"phase_seconds": PHASE_S, "card": card}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--rank":   # a rank of phase 7
        rank_main(int(sys.argv[2]), sys.argv[3])
    elif sys.argv[1:] == ["--diffwave"]:
        diffwave_main()
    else:
        main()
