"""Mask-providing test set for the short-gaps evaluation (port of
``aid_tpu/data/masked.py``): WAV files with per-file masks beside them, as
``.npy`` (bool or float [T]) or MATLAB ``.mat`` (the first 0/1 variable),
matched by file stem."""
from __future__ import annotations

import glob
import os
from typing import Optional

import numpy as np

from aid_tpu_torch.data.audiofolder import glob_audio, read_padded


def load_mask(path: str, length: int) -> np.ndarray:
    """A mask file as float32 [length]: padded with 1 (observed), or cut."""
    if path.endswith(".npy"):
        m = np.load(path)
    elif path.endswith(".mat"):
        import scipy.io
        arrays = [v for k, v in scipy.io.loadmat(path).items() if not k.startswith("__")]
        if not arrays:
            raise ValueError(f"no mask variable in {path}")
        m = arrays[0]
    else:
        raise ValueError(f"unsupported mask format: {path}")
    m = np.asarray(m).astype(np.float32).reshape(-1)
    if m.shape[0] < length:
        m = np.pad(m, (0, length - m.shape[0]), constant_values=1.0)
    return m[:length]


class MaskedAudioDatasetTest:
    """Finite test set: (audio, mask, fs, filename)."""

    def __init__(self, args, *rest, **kw):
        test = args.dset.test
        self.path = str(test.get("path", args.dset.path))
        self.mask_path = str(test.get("mask_path", self.path))
        self.num_samples = int(test.get("num_samples", 4))
        self.seg_len = int(args.exp.audio_len * args.exp.get("resample_factor", 1))
        self.files = glob_audio(self.path)[: self.num_samples]

    def _find_mask(self, stem: str) -> Optional[str]:
        for ext in (".npy", ".mat"):
            cands = glob.glob(os.path.join(self.mask_path, "**", stem + ext), recursive=True)
            if cands:
                return cands[0]
        return None

    def __len__(self):
        return len(self.files)

    def __iter__(self):
        for f in self.files:
            x, fs = read_padded(f, self.seg_len)
            stem = os.path.splitext(os.path.basename(f))[0]
            mp = self._find_mask(stem)
            if mp is None:
                raise FileNotFoundError(
                    f"no mask (.npy/.mat) named {stem}.* under {self.mask_path}")
            yield x, load_mask(mp, self.seg_len), fs, os.path.basename(f)
