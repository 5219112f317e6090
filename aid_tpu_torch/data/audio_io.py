"""Audio file I/O on the host: WAV through the standard library's ``wave``,
host resampling through ``scipy.signal.resample_poly``.

The port's own copy of ``aid_tpu/data/audio_io.py`` without its native
reader: FLAC decoding and libsoxr resampling wait for the native audio
library's port (ROADMAP queue 1, "native audio I/O"). MAESTRO v3 ships WAV.
"""
from __future__ import annotations

import math
import wave as _wave
from typing import Tuple

import numpy as np
import scipy.signal


def _check_wav(path: str) -> None:
    if path.lower().endswith(".flac"):
        raise ValueError(
            f"cannot decode {path!r}: FLAC needs the native audio library, which "
            "aid_tpu_torch does not have yet (ROADMAP queue 1, native audio I/O); "
            "convert the corpus to WAV")


def info(path: str) -> Tuple[int, int, int]:
    """(num_frames, sample_rate, channels) without decoding the file."""
    _check_wav(path)
    with _wave.open(path, "rb") as w:
        return w.getnframes(), w.getframerate(), w.getnchannels()


def read(path: str, start: int = 0, frames: int = -1) -> Tuple[np.ndarray, int]:
    """Mono float32 [T] segment and sample rate; start and frames in samples
    (frames < 0: to the end). Channels are averaged."""
    _check_wav(path)
    with _wave.open(path, "rb") as w:
        fs = w.getframerate()
        ch = w.getnchannels()
        sw = w.getsampwidth()
        n_total = w.getnframes()
        n = n_total - start if frames < 0 else min(frames, n_total - start)
        n = max(n, 0)
        w.setpos(min(start, n_total))
        raw = w.readframes(n)
    if sw == 2:
        x = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
    elif sw == 4:
        x = np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0
    elif sw == 3:
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
        x = ((b[:, 0].astype(np.int32)) | (b[:, 1].astype(np.int32) << 8)
             | (b[:, 2].astype(np.int32) << 16))
        x = (x - ((x & 0x800000) << 1)).astype(np.float32) / 8388608.0
    elif sw == 1:
        x = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {sw} in {path}")
    if ch > 1:
        x = x.reshape(-1, ch).mean(axis=1)
    return x, fs


def write(path: str, audio: np.ndarray, fs: int,
          normalize_if_clipping: bool = True) -> np.ndarray:
    """Write mono float32 as 16-bit WAV, peak-normalised only when it would
    clip. Returns the samples written (before 16-bit rounding)."""
    x = np.asarray(audio, np.float32).reshape(-1)
    peak = float(np.max(np.abs(x))) if x.size else 0.0
    if normalize_if_clipping and peak > 1.0:
        x = x / peak
    with _wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(int(fs))
        w.writeframes((np.clip(x, -1, 1) * 32767.0).astype("<i2").tobytes())
    return x


def resample_host(x: np.ndarray, fs_in: float, fs_out: float) -> np.ndarray:
    """Host-side rational resampling (``scipy.signal.resample_poly``)."""
    if fs_in == fs_out:
        return np.asarray(x, np.float32)
    g = math.gcd(int(fs_in), int(fs_out))
    return scipy.signal.resample_poly(np.asarray(x, np.float32), int(fs_out) // g,
                                      int(fs_in) // g).astype(np.float32)
