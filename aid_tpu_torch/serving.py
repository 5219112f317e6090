"""Serving layer: arbitrary-length audio inpainting as a library call (port
of ``aid_tpu/serving.py``).

  * each gap gets a model-length window centred on it;
  * windows are batched up to ``max_batch`` rows per guided-Heun call; a
    round runs the sampler's program for the rows it has (one program per
    row count, CUDA graphs on the card, all in one graph pool);
  * gaps longer than ``LONG_GAP_FRACTION`` of a window are filled by chained
    sub-windows, each conditioned on ``CHAIN_CONTEXT_FRACTION`` of leading
    context, marching left to right; a work-queue scheduler co-batches one
    pass per chain with pending single-window jobs;
  * every window's observation mask is sliced from a live mask (unknown
    samples flip to known only after write-back);
  * reconstructions are written back only inside the gaps;
  * input at another sample rate is resampled to the model's rate and the
    result back (``data.audio_io.resample_host``: libsoxr where the native
    library has it), the gap mask mapped sample by sample; every observed
    input sample comes back exactly;
  * ``inpaint_file`` reads a file, restores it and writes it at its rate;
  * ``precompile`` builds the programs for every row count up to
    ``max_batch`` without running them, and ``autotune_max_batch`` fits
    ``max_batch`` to the card's memory from the programs' ``memory_bytes()``;
  * ``shard(mesh)`` serves over a process group's ranks: a ``"dp"`` mesh
    splits each round's windows over the ranks, a ("dp", "tp") mesh also
    splits every conv and dense layer's output channels
    (``parallel.tp``), a ("dp", "cp") mesh every activation's time axis
    (full-score context parallelism, ``parallel.cp``). Over a dp mesh each
    rank runs its rows through its own programs (a trajectory makes no
    collective; the blocks are all-gathered after it), under any backend;
    over tp or cp the collectives sit inside every score and the sampler
    runs eagerly (``Sampler.programs_enabled``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from aid_tpu_torch import setup as tsetup
from aid_tpu_torch.data import audio_io
from aid_tpu_torch.parallel import mesh as pmesh
from aid_tpu_torch.parallel import ring_attention as ring
from aid_tpu_torch.parallel import tp
from aid_tpu_torch.sampling import degradations as degr
from aid_tpu_torch.sampling.heun import make_score_fn


@dataclasses.dataclass
class _Chain:
    """March state for a gap longer than one window: ``pos`` is the first
    still-unfilled sample; each pass fills [pos, min(g1, window_end))."""
    g0: int
    g1: int
    pos: int


def find_gaps(mask: np.ndarray) -> List[Tuple[int, int]]:
    """Contiguous zero-runs of a binary sample mask -> [(start, end)) list."""
    m = np.asarray(mask).reshape(-1) > 0.5
    edges = np.flatnonzero(np.diff(np.concatenate([[True], m, [True]])))
    return [(int(edges[i]), int(edges[i + 1])) for i in range(0, len(edges), 2)]


@dataclasses.dataclass
class InpaintingService:
    args: object
    network: object
    sampler: object
    max_batch: int = 2
    mesh: object = None

    LONG_GAP_FRACTION = 0.6
    CHAIN_CONTEXT_FRACTION = 0.25

    @classmethod
    def from_config(cls, overrides: Sequence[str] = (), device=None,
                    max_batch: Optional[int] = None, seed: int = 0,
                    checkpoint: Optional[str] = None) -> "InpaintingService":
        """Compose the config, build the network on ``device`` (CUDA unless
        named), the EDM parameters and the sampler. Weights: the EMA of
        ``checkpoint`` (as ``Tester.load_checkpoint`` reads it: a reference
        ``.pt``, the port's own or a JAX stream ``.ckpt``), else seeded
        random ones."""
        from aid_tpu_torch.utils.config import compose
        args = compose(overrides=list(overrides))
        if max_batch is None:
            max_batch = int(args.network.get("serving_max_batch", 2))
        network = tsetup.setup_network(args, device=device, seed=seed)
        diff = tsetup.setup_diff_parameters(args)
        if checkpoint:
            from aid_tpu_torch.testing.tester import Tester
            tester = Tester(args, network=network, diff_params=diff, device=device)
            if not tester.load_checkpoint(checkpoint):
                raise FileNotFoundError(checkpoint)
            sampler = tester.sampler
        else:
            sampler = tsetup.setup_sampler(args, network=network, diff_params=diff)
        return cls(args=args, network=network, sampler=sampler, max_batch=max_batch)

    @property
    def device(self) -> torch.device:
        return next(self.network.parameters()).device

    # ------------------------------------------------------------ parallelism

    def shard(self, mesh=None) -> "InpaintingService":
        """Serve over the ranks of a process group (started first, e.g. by
        ``torchrun`` and ``parallel.mesh.init_distributed``); every rank
        builds the same service, calls ``shard`` and then ``inpaint`` with
        the same request, and every rank returns the whole answer.

        1-D ``"dp"`` mesh (default: every rank): ``max_batch`` is the global
        batch, rounded up to a multiple of the dp size. Each round's window
        batch is split into equal row blocks, one per rank (the last row
        repeated to fill the last block); the noise is drawn for the whole
        round from its seed and sliced, so the answer is the one-rank
        answer. The blocks are all-gathered.

        2-D ("dp", "tp") mesh (``parallel.tp.make_tp_mesh``): each tp group
        runs a dp block with every conv and dense layer's output channels
        split over it (lower latency per score). Not with int8 weights.

        2-D ("dp", "cp") mesh (``parallel.ring_attention.make_cp_mesh``):
        each cp group runs a dp block with every activation's frame-time
        axis split over it (``parallel.cp``: halo exchanges around the
        convs and resamplers, group-norm moments all-reduced, ring
        attention); weights stay replicated. The network's
        ``context_parallel`` flags (``network`` and ``attention_dict``) are
        turned on, with the same parameters, and the mesh is installed
        (``ring.set_cp_mesh``). A mesh with both tp and cp raises
        ValueError: pick one latency axis."""
        if not dist.is_initialized():
            raise RuntimeError("shard serves over a process group: call "
                               "aid_tpu_torch.parallel.mesh.init_distributed() first")
        mesh = mesh if mesh is not None else pmesh.make_mesh(device_type=self.device.type)
        n_tp = pmesh.dim_size(mesh, tp.MODEL_AXIS)
        n_cp = pmesh.dim_size(mesh, ring.CP_AXIS)
        if n_tp > 1 and n_cp > 1:
            raise ValueError("serving over a tp x cp mesh is not supported: pick one latency "
                             "axis (tp splits the kernels, cp the time axis)")
        if n_cp > 1:
            self.args.network["context_parallel"] = True
            if "attention_dict" in self.args.network:
                self.args.network["attention_dict"]["context_parallel"] = True
            for m in self.network.modules():      # the U-Net and its attention layers
                if hasattr(m, "context_parallel"):
                    m.context_parallel = True
            ring.set_cp_mesh(mesh)
        if n_tp > 1:
            if str(self.args.network.get("quant", "none")) != "none":
                raise ValueError("tensor-parallel serving does not compose with int8 "
                                 "quantization (network.quant must be 'none')")
            tp.place_params(self.network, mesh)
        n_dp = pmesh.dim_size(mesh, pmesh.DATA_AXIS)
        self.max_batch = -(-self.max_batch // n_dp) * n_dp
        self.mesh = mesh
        return self

    def _run_batch(self, xb: np.ndarray, mb: np.ndarray, seed: int) -> np.ndarray:
        """One guided-Heun call on an [n, L] window batch, its noise drawn
        from a generator seeded with ``seed``: the sampler's program for n
        rows; over a mesh, this rank's dp block of k = ceil(n / n_dp) rows
        (its program for k rows over a dp mesh, eagerly over tp or cp), the
        blocks then all-gathered."""
        y = torch.from_numpy((xb * mb).astype(np.float32)).to(self.device)
        m = torch.from_numpy(mb.astype(np.float32)).to(self.device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        if self.mesh is None:
            rec = self.sampler.predict_inpainting(y, m, generator=gen)
            return rec.float().cpu().numpy()
        n = y.shape[0]
        n_dp = pmesh.dim_size(self.mesh, pmesh.DATA_AXIS)
        k = -(-n // n_dp)
        r = self.mesh.get_local_rank(pmesh.DATA_AXIS)
        rows = torch.arange(r * k, (r + 1) * k, device=self.device).clamp(max=n - 1)
        prior, churn = self.sampler.noise_rows(tuple(y.shape), rows, gen)
        rec = self.sampler.predict_inpainting(y[rows], m[rows], prior=prior, churn=churn)
        parts = [torch.empty_like(rec) for _ in range(n_dp)]
        dist.all_gather(parts, rec.contiguous(), group=self.mesh.get_group(pmesh.DATA_AXIS))
        return torch.cat(parts)[:n].float().cpu().numpy()

    def _guided_score_once(self, n: int, seed: int = 0) -> None:
        """One guided score (denoiser forward and input gradient) at
        [n, audio_len] on a fixed mask (its second quarter missing), at the
        largest sigma; x is drawn from a generator of its own, seeded with
        ``seed``. Synchronised; the result is discarded."""
        L = int(self.args.exp.audio_len)
        dev, s = self.device, self.sampler
        mask = torch.ones(n, L, device=dev)
        mask[:, L // 4:L // 2] = 0.0
        gen = torch.Generator(device=dev).manual_seed(seed)
        y = 0.1 * torch.randn(n, L, generator=gen, device=dev) * mask
        score = make_score_fn(s.p, s.cfg, s._denoise, y=y, degradation=degr.time_mask(mask),
                              proj=degr.inpainting_projector(y, mask), hpf=s._hpf())
        t = torch.tensor(float(s.p.sigma_max), device=dev)
        score(float(s.p.sigma_max) * torch.randn(n, L, generator=gen, device=dev), t)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def _n_dp(self) -> int:
        return 1 if self.mesh is None else pmesh.dim_size(self.mesh, pmesh.DATA_AXIS)

    def precompile(self, seed: int = 0) -> None:
        """Build the guided-Heun programs without running them (on the card:
        warm-up and CUDA graph capture), as the JAX package compiles its
        program here: the one for [max_batch, audio_len] first, then one
        for each smaller row count, since a round runs only the rows it has
        (JAX pads every round to max_batch). Draws nothing from any
        request's noise. After ``shard`` every rank calls it: over a dp
        mesh it builds this rank's programs, for max_batch / n_dp rows down
        to 1; over tp or cp, whose trajectories run eagerly, it warms this
        rank's rows with one guided score."""
        rows = self.max_batch // self._n_dp()
        if not self.sampler.programs_enabled():
            self._guided_score_once(rows, seed)
            return
        for n in range(rows, 0, -1):
            self._compiled_for_batch(n)

    def _compiled_for_batch(self, n: int):
        """The sampler's inpainting program for [n, audio_len] rounds (a
        rank's n rows over a dp mesh), built on first use."""
        L = int(self.args.exp.audio_len)
        mask = torch.ones(n, L, device=self.device)
        mask[:, L // 4:L // 2] = 0.0
        return self.sampler.compile_inpainting(torch.zeros(n, L, device=self.device), mask)

    def _footprint(self, n: int) -> int:
        """Device bytes of guided sampling at [n, audio_len] on one device:
        the network's weights plus the program's ``memory_bytes()`` (its
        static buffers and the graph pool its capture took). A probe wider
        than a device's rows of ``max_batch`` is dropped with the graph
        pool it grew (``precompile`` builds what serves)."""
        weights = sum(p.numel() * p.element_size() for p in self.network.parameters())
        nbytes = weights + self._compiled_for_batch(n).memory_bytes()
        if n > self.max_batch // self._n_dp():
            self.sampler.release_programs()
        return nbytes

    def autotune_max_batch(self, limit_bytes: Optional[int] = None,
                           margin: float = 0.85, cap: int = 16) -> int:
        """Fit ``max_batch`` to device memory from the footprints of the
        programs at 1 and 2 rows a device: the per-row bytes are their
        difference, the rest is fixed. The rows a device can take are the
        most whose footprint stays under ``margin * limit_bytes`` (at most
        ``cap``); after ``shard`` over a dp mesh every rank measures its
        own and they agree on the smallest (an all-reduce), since the ranks
        serve each round in lockstep. Returns the batch that fits (the
        device's rows times the dp size) and caps ``max_batch`` with it; it
        never raises a configured ``max_batch`` (fitting memory is
        necessary, the throughput optimum may be lower). ``limit_bytes``
        defaults to the card's memory. Raises when not even one row fits
        on some rank, and over a tp or cp mesh (its trajectories run
        eagerly: there is no program to measure)."""
        if self.mesh is not None and not self.sampler.programs_enabled():
            raise RuntimeError("autotune_max_batch measures the sampler's programs; over a "
                               "tp or cp mesh the trajectory runs eagerly: call it before "
                               "shard()")
        if limit_bytes is None:
            if self.device.type != "cuda":
                raise ValueError(f"no device memory limit on {self.device}; pass limit_bytes")
            limit_bytes = torch.cuda.get_device_properties(self.device).total_memory
        f1, f2 = self._footprint(1), self._footprint(2)
        per_row = max(f2 - f1, 1)
        fixed = max(f1 - per_row, 0)
        budget = margin * limit_bytes
        fit = int((budget - fixed) // per_row)
        if self.mesh is not None:   # before the raise: every rank raises, or none
            least = torch.tensor(float(fit), device=self.device)
            pmesh.all_reduce(least, op=dist.ReduceOp.MIN)
            fit = int(least.item())
        if fit < 1:
            raise RuntimeError(
                f"guided sampling does not fit: fixed {fixed / 2 ** 30:.2f} GiB"
                f" + {per_row / 2 ** 30:.2f} GiB/row vs budget {budget / 2 ** 30:.2f} GiB"
                f"{' (on the tightest rank)' if self.mesh is not None else ''}")
        n_dp = self._n_dp()
        rows = min(fit, cap) * n_dp
        self.max_batch = max(n_dp, min(self.max_batch, rows))
        return rows

    def inpaint(self, audio: np.ndarray, mask: np.ndarray, fs: int,
                seed: int = 0) -> np.ndarray:
        """Restore the masked samples of an arbitrary-length mono signal at
        sample rate ``fs``."""
        model_fs = int(self.args.exp.sample_rate)
        L = int(self.args.exp.audio_len)
        audio = np.asarray(audio, np.float32).reshape(-1)
        mask = np.asarray(mask, np.float32).reshape(-1)
        if audio.shape != mask.shape:
            raise ValueError("audio and mask must have the same length")
        if fs != model_fs:
            # each model-rate sample takes the mask of the input sample it
            # falls on
            audio_m = audio_io.resample_host(audio, fs, model_fs)
            idx = (np.arange(len(audio_m)) / (model_fs / fs)).astype(np.int64)
            mask_m = mask[np.clip(idx, 0, len(mask) - 1)]
        else:
            audio_m, mask_m = audio, mask

        orig_len = len(audio_m)
        if orig_len < L:  # short inputs: pad as pinned (observed) silence
            audio_m = np.pad(audio_m, (0, L - orig_len))
            mask_m = np.pad(mask_m, (0, L - orig_len), constant_values=1.0)

        T = len(audio_m)
        gaps = find_gaps(mask_m)
        if not gaps:
            return audio.copy()
        out = audio_m.copy()
        cur_mask = mask_m.copy()   # live: 0 = still unknown

        long_gap = int(self.LONG_GAP_FRACTION * L)
        ready = []   # single-window jobs: (w0, a, b), own gap at [a, b)
        chains = []  # long gaps marching left to right
        for g0, g1 in gaps:
            if g1 - g0 > long_gap:
                chains.append(_Chain(g0=g0, g1=g1, pos=g0))
            else:
                c = (g0 + g1) // 2
                w0 = int(np.clip(c - L // 2, 0, T - L))
                ready.append((w0, max(g0 - w0, 0), min(g1 - w0, L)))

        seeds = np.random.default_rng(seed)   # one noise seed per round
        ctx = max(1, int(self.CHAIN_CONTEXT_FRACTION * L))
        while ready or chains:
            batch = []  # (w0, a, b, chain-or-None)
            # leave a row for single-window jobs whenever any are pending;
            # chains not scheduled rotate to the front next round
            n_chain = min(len(chains), self.max_batch - 1 if ready else self.max_batch)
            for ch in chains[:n_chain]:
                w0 = int(np.clip(ch.pos - ctx, 0, T - L))
                fill_hi = min(ch.g1, w0 + L)
                batch.append((w0, ch.pos - w0, fill_hi - w0, ch))
            while len(batch) < self.max_batch and ready:
                batch.append(ready.pop(0) + (None,))
            xb = np.zeros((len(batch), L), np.float32)
            mb = np.ones((len(batch), L), np.float32)
            for r, (w0, a, b, _) in enumerate(batch):
                xb[r] = out[w0:w0 + L]
                mb[r] = cur_mask[w0:w0 + L]
                mb[r, a:b] = 0.0
            rec = self._run_batch(xb, mb, int(seeds.integers(2 ** 62)))
            done = []
            for r, (w0, a, b, ch) in enumerate(batch):
                # write back only the row's own fill range
                out[w0 + a:w0 + b] = rec[r, a:b]
                cur_mask[w0 + a:w0 + b] = 1.0
                if ch is not None:
                    ch.pos = w0 + b
                    if ch.pos >= ch.g1:
                        done.append(ch)
            finished = {id(ch) for ch in done}
            chains = (chains[n_chain:]
                      + [ch for ch in chains[:n_chain] if id(ch) not in finished])

        out = out[:orig_len]
        if fs != model_fs:
            restored = audio_io.resample_host(out, model_fs, fs)[: len(audio)]
            restored = np.pad(restored, (0, len(audio) - len(restored)))
            # every observed input sample exactly as it came
            return np.where(mask > 0.5, audio, restored).astype(np.float32)
        return np.where(mask_m[:orig_len] > 0.5, audio, out).astype(np.float32)

    def inpaint_file(self, in_path: str, mask: np.ndarray, out_path: str,
                     seed: int = 0) -> str:
        """Read ``in_path`` (WAV or FLAC, mono-mixed), restore the samples
        where ``mask`` is 0 and write a 16-bit WAV at the input's rate."""
        audio, fs = audio_io.read(in_path)
        audio_io.write(out_path, self.inpaint(audio, mask, fs, seed=seed), fs)
        return out_path
