"""MAESTRO v3 dataset loaders driven by the corpus's metadata CSV.

The port's own copy of ``aid_tpu/data/maestro.py``:
  MaestroDatasetFs          infinite train iterator: filter the CSV by split and
                            year, draw a random file, then ``segments_per_file``
                            random native-rate segments of it; yields
                            (segment [load_len], fs)
  MaestroDataset            the same, resampled on the host to exp.sample_rate
  MaestroDatasetTestChunks  the first num_samples test files, one chunk at a
                            10 s offset each; yields (audio, fs, filename)

The draws come from numpy's ``default_rng`` in the same order as the JAX
package's loader, so for the same seed and files both yield the same
segments.
"""
from __future__ import annotations

import csv
import os
import wave
from typing import Iterator, List, Tuple

import numpy as np

from aid_tpu_torch.data import audio_io


def _process_seed(base: int) -> int:
    """Per-process seed: with ``torch.distributed`` initialised, each rank
    draws its own stream (base + 1000003 rank); otherwise the base seed."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return int(base) + 1000003 * dist.get_rank()
    return int(base)


def _load_metadata(root: str) -> List[dict]:
    for name in ("maestro-v3.0.0.csv", "maestro-v2.0.0.csv"):
        c = os.path.join(root, name)
        if os.path.exists(c):
            with open(c, newline="") as f:
                return list(csv.DictReader(f))
    raise FileNotFoundError(f"no maestro metadata CSV under {root}")


class MaestroDatasetFs:
    """Infinite train iterator yielding (native-rate segment [T], fs)."""

    SEGMENTS_PER_FILE = 8

    def __init__(self, args, *rest, **kw):
        dset = args.dset
        self.path = str(dset.path)
        self.years = set(int(y) for y in dset.get("years", []))
        self.load_len = int(dset.get("load_len", 405000))
        self.overfit = bool(dset.get("overfit", False))
        self.segments_per_file = int(dset.get("segments_per_file", self.SEGMENTS_PER_FILE))
        self.seed = _process_seed(int(args.exp.get("seed", 42)))
        meta = _load_metadata(self.path)
        self.files = [os.path.join(self.path, r["audio_filename"])
                      for r in meta
                      if r.get("split") == "train"
                      and (not self.years or int(r["year"]) in self.years)]
        if not self.files:
            raise FileNotFoundError(
                f"no train files for years {sorted(self.years)} under {self.path}")

    def __iter__(self) -> Iterator[Tuple[np.ndarray, int]]:
        rng = np.random.default_rng(self.seed)
        if self.overfit:
            # one cached segment forever: isolates the data path from training
            f = self.files[0]
            n, fs, _ = audio_io.info(f)
            x, fs = audio_io.read(f, 0, min(self.load_len, n))
            while True:
                yield x, fs
        # skipped files are counted, so a corpus where no file is usable
        # fails loudly instead of looping forever
        failures = 0
        while True:
            f = self.files[rng.integers(len(self.files))]
            try:
                n, fs, _ = audio_io.info(f)
            except (OSError, EOFError, ValueError, wave.Error) as e:
                failures += 1
                if failures >= 50:
                    raise RuntimeError(
                        f"{failures} consecutive unusable files under "
                        f"{self.path!r} (last: {f!r}: {e})") from e
                continue
            if n < self.load_len:
                failures += 1
                if failures >= 50:
                    raise RuntimeError(
                        f"{failures} consecutive unusable files under {self.path!r}: "
                        f"files shorter than load_len={self.load_len} (last: {f!r} "
                        f"with {n} samples); lower dset.load_len")
                continue
            failures = 0
            for _ in range(self.segments_per_file):
                start = int(rng.integers(0, n - self.load_len + 1))
                x, _ = audio_io.read(f, start, self.load_len)
                yield x, fs


class MaestroDataset(MaestroDatasetFs):
    """Fixed-rate variant: resamples on the host to exp.sample_rate, so fs is
    constant downstream."""

    def __init__(self, args, *rest, **kw):
        super().__init__(args, *rest, **kw)
        self.target_fs = int(args.exp.sample_rate)
        self.seg_len = int(args.exp.audio_len)

    def __iter__(self):
        for x, fs in super().__iter__():
            y = audio_io.resample_host(x, fs, self.target_fs)
            if y.shape[-1] < self.seg_len:
                y = np.pad(y, (0, self.seg_len - y.shape[-1]))
            yield y[:self.seg_len], self.target_fs


class MaestroDatasetTestChunks:
    """Finite test set: (audio, fs, filename) per file, one chunk at a fixed
    10 s offset."""

    OFFSET_SECONDS = 10.0

    def __init__(self, args, *rest, **kw):
        dset = args.dset
        self.path = str(dset.path)
        years = set(int(y) for y in dset.get("years_test", []))
        self.num_samples = int(dset.test.get("num_samples", 4))
        self.seg_len = int(args.exp.audio_len * args.exp.get("resample_factor", 1))
        meta = _load_metadata(self.path)
        files = [os.path.join(self.path, r["audio_filename"])
                 for r in meta
                 if r.get("split") == "test"
                 and (not years or int(r["year"]) in years)]
        self.files = files[: self.num_samples]

    def __len__(self) -> int:
        return len(self.files)

    def __iter__(self):
        for f in self.files:
            n, fs, _ = audio_io.info(f)
            start = min(int(self.OFFSET_SECONDS * fs), max(n - self.seg_len, 0))
            x, fs = audio_io.read(f, start, self.seg_len)
            if x.shape[-1] < self.seg_len:
                x = np.pad(x, (0, self.seg_len - x.shape[-1]))
            yield x, fs, os.path.basename(f)
