"""Audio-folder loaders (port of ``aid_tpu/data/audiofolder.py``, the
MusicNet path): an infinite random-segment train iterator over a directory
of WAVs, and a finite test set of the first ``num_samples`` files."""
from __future__ import annotations

import glob
import os
import wave
from typing import Iterator, List, Tuple

import numpy as np

from aid_tpu_torch.data import audio_io
from aid_tpu_torch.data.maestro import _process_seed


def glob_audio(path: str) -> List[str]:
    files = sorted(glob.glob(os.path.join(path, "**", "*.wav"), recursive=True))
    if not files:
        raise FileNotFoundError(f"no wav files under {path}")
    return files


def read_padded(path: str, seg_len: int) -> Tuple[np.ndarray, int]:
    """The first ``seg_len`` samples of a file, zero-padded when shorter."""
    x, fs = audio_io.read(path, 0, seg_len)
    if x.shape[-1] < seg_len:
        x = np.pad(x, (0, seg_len - x.shape[-1]))
    return x, fs


class AudioFolderDataset:
    """Infinite train iterator yielding (segment [audio_len x resample_factor],
    fs); a file shorter than a segment is wrapped around."""

    def __init__(self, args, *rest, **kw):
        self.path = str(args.dset.path)
        self.overfit = bool(args.dset.get("overfit", False))
        self.seg_len = int(args.exp.audio_len * args.exp.get("resample_factor", 1))
        self.seed = _process_seed(int(args.exp.get("seed", 42)))
        self.files = glob_audio(self.path)

    def _read_wrapped(self, f: str, start: int) -> Tuple[np.ndarray, int]:
        x, fs = audio_io.read(f, start, self.seg_len)
        while x.shape[-1] < self.seg_len:
            extra, _ = audio_io.read(f, 0, self.seg_len - x.shape[-1])
            if extra.size == 0:
                extra = np.zeros(self.seg_len - x.shape[-1], np.float32)
            x = np.concatenate([x, extra])
        return x, fs

    def __iter__(self) -> Iterator[Tuple[np.ndarray, int]]:
        rng = np.random.default_rng(self.seed)
        if self.overfit:
            x, fs = self._read_wrapped(self.files[0], 0)
            while True:
                yield x, fs
        while True:
            f = self.files[rng.integers(len(self.files))]
            try:
                n, fs, _ = audio_io.info(f)
            except (OSError, EOFError, ValueError, wave.Error):
                continue
            start = int(rng.integers(0, max(n - self.seg_len, 0) + 1))
            yield self._read_wrapped(f, start)


class AudioFolderDatasetTest:
    """Finite test set: (audio, fs, filename) for the first num_samples files."""

    def __init__(self, args, *rest, **kw):
        test = args.dset.test
        self.path = str(test.get("path", args.dset.path))
        self.num_samples = int(test.get("num_samples", 4))
        self.seg_len = int(args.exp.audio_len * args.exp.get("resample_factor", 1))
        self.files = glob_audio(self.path)[: self.num_samples]

    def __len__(self) -> int:
        return len(self.files)

    def __iter__(self):
        for f in self.files:
            x, fs = read_padded(f, self.seg_len)
            yield x, fs, os.path.basename(f)
