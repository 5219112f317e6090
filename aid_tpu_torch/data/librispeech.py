"""LibriSpeech loaders (the port's own copy of ``aid_tpu/data/librispeech.py``).

The corpus ships FLAC, decoded by the port's native audio library
(``data/audio_io.py``); WAV mirrors work too.
  LibrispeechTrain  infinite random segments of exp.audio_len x resample_factor
                    samples; a short utterance is tiled (pad-wrap) first; a
                    corpus that yields 50 decode failures in a row aborts
  LibrispeechTest   the first num_samples files, zero-padded or cut to the
                    segment length; yields (audio, fs, filename)

The draws come from numpy's ``default_rng`` in the JAX package's order, so
for the same seed and files both yield the same segments.
"""
from __future__ import annotations

import glob
import os
import wave
from typing import Iterator, List, Tuple

import numpy as np

from aid_tpu_torch.data import audio_io
from aid_tpu_torch.data.maestro import _process_seed


def _glob_speech(path: str) -> List[str]:
    files = sorted(glob.glob(os.path.join(path, "**", "*.wav"), recursive=True))
    if not files:
        files = sorted(glob.glob(os.path.join(path, "**", "*.flac"), recursive=True))
    if not files:
        raise FileNotFoundError(f"no wav/flac files under {path}")
    return files


def _seg_len(args) -> int:
    return int(args.exp.audio_len * args.exp.get("resample_factor", 1))


class LibrispeechTrain:
    # An undecodable file is skipped with a message, but a corpus that yields
    # nothing but failures aborts instead of spinning forever.
    MAX_CONSECUTIVE_FAILURES = 50

    def __init__(self, args, *rest, **kw):
        self.path = str(args.dset.path)
        self.seg_len = _seg_len(args)
        self.seed = _process_seed(int(args.exp.get("seed", 42)))
        self.overfit = bool(args.dset.get("overfit", False))
        self.files = _glob_speech(self.path)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, int]]:
        rng = np.random.default_rng(self.seed)
        failures = 0
        while True:
            f = self.files[0 if self.overfit else rng.integers(len(self.files))]
            try:
                x, fs = audio_io.read(f)
            except (OSError, EOFError, ValueError, wave.Error) as e:
                failures += 1
                print(f"[librispeech] skipping undecodable {f!r}: {e} "
                      f"({failures} consecutive failures)", flush=True)
                if failures >= self.MAX_CONSECUTIVE_FAILURES:
                    raise RuntimeError(
                        f"{failures} consecutive decode failures under {self.path!r}; "
                        f"corpus unreadable (last: {f!r})") from e
                continue
            failures = 0
            if x.shape[-1] < self.seg_len:  # pad-wrap
                x = np.tile(x, int(np.ceil(self.seg_len / max(x.shape[-1], 1))))
            start = int(rng.integers(0, x.shape[-1] - self.seg_len + 1))
            yield x[start:start + self.seg_len], fs


class LibrispeechTest:
    def __init__(self, args, *rest, **kw):
        test = args.dset.test
        self.path = str(test.get("path", args.dset.path))
        self.num_samples = int(test.get("num_samples", 4))
        self.seg_len = _seg_len(args)
        self.files = _glob_speech(self.path)[: self.num_samples]

    def __len__(self) -> int:
        return len(self.files)

    def __iter__(self):
        for f in self.files:
            x, fs = audio_io.read(f)
            if x.shape[-1] < self.seg_len:
                x = np.pad(x, (0, self.seg_len - x.shape[-1]))
            yield x[: self.seg_len], fs, os.path.basename(f)
