"""Serving layer: arbitrary-length audio inpainting as a library call (port
of ``aid_tpu/serving.py``).

  * each gap gets a model-length window centred on it;
  * windows are batched up to ``max_batch`` rows per guided-Heun call (a
    round runs only the rows it has: eager PyTorch has no fixed batch shape);
  * gaps longer than ``LONG_GAP_FRACTION`` of a window are filled by chained
    sub-windows, each conditioned on ``CHAIN_CONTEXT_FRACTION`` of leading
    context, marching left to right; a work-queue scheduler co-batches one
    pass per chain with pending single-window jobs;
  * every window's observation mask is sliced from a live mask (unknown
    samples flip to known only after write-back);
  * reconstructions are written back only inside the gaps.

Input must be at the model's sample rate; resampling (``audio_io``),
``shard``, ``precompile``, ``autotune_max_batch``, ``inpaint_file`` and
checkpoint loading wait for later slices.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from aid_tpu_torch import setup as tsetup


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

    LONG_GAP_FRACTION = 0.6
    CHAIN_CONTEXT_FRACTION = 0.25

    @classmethod
    def from_config(cls, overrides: Sequence[str] = (), device=None,
                    max_batch: Optional[int] = None, seed: int = 0) -> "InpaintingService":
        """Compose the config, build the network (seeded random weights) on
        ``device`` (CUDA unless named), the EDM parameters and the sampler."""
        from aid_tpu_torch.utils.config import compose
        args = compose(overrides=list(overrides))
        if max_batch is None:
            max_batch = int(args.network.get("serving_max_batch", 2))
        network = tsetup.setup_network(args, device=device, seed=seed)
        diff = tsetup.setup_diff_parameters(args)
        sampler = tsetup.setup_sampler(args, network=network, diff_params=diff)
        return cls(args=args, network=network, sampler=sampler, max_batch=max_batch)

    @property
    def device(self) -> torch.device:
        return next(self.network.parameters()).device

    def _run_batch(self, xb: np.ndarray, mb: np.ndarray, seed: int) -> np.ndarray:
        """One guided-Heun call on an [n, L] window batch, its noise drawn
        from a generator seeded with ``seed``."""
        y = torch.from_numpy((xb * mb).astype(np.float32)).to(self.device)
        m = torch.from_numpy(mb.astype(np.float32)).to(self.device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        rec = self.sampler.predict_inpainting(y, m, generator=gen)
        return rec.float().cpu().numpy()

    def inpaint(self, audio: np.ndarray, mask: np.ndarray, fs: int,
                seed: int = 0) -> np.ndarray:
        """Restore the masked samples of an arbitrary-length mono signal."""
        model_fs = int(self.args.exp.sample_rate)
        L = int(self.args.exp.audio_len)
        audio = np.asarray(audio, np.float32).reshape(-1)
        mask = np.asarray(mask, np.float32).reshape(-1)
        if audio.shape != mask.shape:
            raise ValueError("audio and mask must have the same length")
        if fs != model_fs:
            raise NotImplementedError(
                f"input at {fs} Hz: resampling to the model's {model_fs} Hz "
                "is not ported yet")

        orig_len = len(audio)
        audio_m, mask_m = audio, mask
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
        return np.where(mask_m[:orig_len] > 0.5, audio, out).astype(np.float32)
