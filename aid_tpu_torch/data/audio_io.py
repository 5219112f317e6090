"""Audio file I/O on the host: the native library first, Python fallbacks.

The port's own copy of ``aid_tpu/data/audio_io.py``. The native library is
built from the port's C++ sources (``aid_tpu_torch/native/{audioio,flac}.cpp``)
with ``g++ -O2 -shared -fPIC ... -ldl`` at first use, into
``aid_tpu_torch/native/build/`` under a name that carries a hash of the
sources, and loaded with ctypes. It gives WAV info and random-access segment
reads, FLAC info and decoding, 16-bit WAV writes and libsoxr resampling
(libsoxr is opened at run time, so the library loads without it).

Fallbacks, the JAX package's: where the library does not build, WAV goes
through the standard library's ``wave``, resampling through
``scipy.signal.resample_poly``, and FLAC raises; where libsoxr is absent,
resampling goes through ``resample_poly``. A failed build warns once with the
compiler's output; ``resampler_route()`` and ``native_status()`` say which
route runs.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import math
import os
import subprocess
import threading
import warnings
import wave as _wave
from typing import Optional, Tuple

import numpy as np

NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")
BUILD_DIR = os.path.join(NATIVE_DIR, "build")
_SOURCES = ("audioio.cpp", "flac.cpp")

_c_long_p = ctypes.POINTER(ctypes.c_long)
_c_int_p = ctypes.POINTER(ctypes.c_int)
_c_float_p = ctypes.POINTER(ctypes.c_float)
_SIGNATURES = {
    "aio_read_info": ([ctypes.c_char_p, _c_long_p, _c_int_p, _c_int_p], ctypes.c_int),
    "aio_read_segment": ([ctypes.c_char_p, ctypes.c_long, ctypes.c_long, _c_float_p],
                         ctypes.c_long),
    "aio_write_wav": ([ctypes.c_char_p, _c_float_p, ctypes.c_long, ctypes.c_int],
                      ctypes.c_int),
    "aio_resample": ([_c_float_p, ctypes.c_long, _c_float_p, ctypes.c_long,
                      ctypes.c_double, ctypes.c_double], ctypes.c_long),
    "aio_soxr_loaded": ([], ctypes.c_int),
    "aio_flac_info": ([ctypes.c_char_p, _c_long_p, _c_int_p, _c_int_p], ctypes.c_int),
    "aio_flac_read_segment": ([ctypes.c_char_p, ctypes.c_long, ctypes.c_long, _c_float_p],
                              ctypes.c_long),
}


def build_and_load(native_dir: str, build_dir: str) -> Tuple[Optional[ctypes.CDLL], str]:
    """Build the library from ``native_dir``'s sources into ``build_dir``
    (once per content of the sources: the name carries their hash) and load
    it. Returns (library, "loaded <path>"), or (None, "build failed: ...")
    after a warning that carries the compiler's output. The build writes a
    private file and renames it into place, so processes that build at the
    same time never load a half-written library."""
    sources = [os.path.join(native_dir, s) for s in _SOURCES]
    h = hashlib.sha256()
    for s in sources:
        with open(s, "rb") as f:
            h.update(f.read())
    path = os.path.join(build_dir, f"libaudioio-{h.hexdigest()[:16]}.so")
    if not os.path.exists(path):
        os.makedirs(build_dir, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        cmd = ["g++", "-O2", "-shared", "-fPIC", "-o", tmp, *sources, "-ldl"]
        try:
            subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=300)
            os.replace(tmp, path)
        except (OSError, subprocess.SubprocessError) as e:
            detail = (getattr(e, "stderr", None) or str(e)).strip()
            warnings.warn("aid_tpu_torch: the native audio library did not build; WAV and "
                          "resampling take the Python routes and FLAC cannot be read.\n"
                          f"{' '.join(cmd)}\n{detail}", RuntimeWarning, stacklevel=2)
            if os.path.exists(tmp):
                os.remove(tmp)
            return None, "build failed: " + (detail.splitlines() or ["?"])[-1]
    try:
        lib = ctypes.CDLL(path)
    except OSError as e:     # e.g. a library built on another machine
        warnings.warn(f"aid_tpu_torch: the native audio library {path} did not load: {e}; "
                      "delete it to build it anew", RuntimeWarning, stacklevel=2)
        return None, f"load failed: {e}"
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    return lib, f"loaded {path}"


@functools.lru_cache(maxsize=None)
def _load() -> Tuple[Optional[ctypes.CDLL], str]:
    """The package's library and its status, built and loaded (or warned
    about) once per process."""
    return build_and_load(NATIVE_DIR, BUILD_DIR)


def _native() -> Optional[ctypes.CDLL]:
    """The native library, or None where it did not build."""
    return _load()[0]


def native_status() -> str:
    """How the native library stands: "loaded <path>" or "build failed: ..."."""
    return _load()[1]


def resampler_route() -> str:
    """"soxr" where the native library is loaded and libsoxr answers,
    else "resample_poly"."""
    lib = _native()
    return "soxr" if lib is not None and lib.aio_soxr_loaded() == 1 else "resample_poly"


# FLAC has no cheap random access (decode is sequential from the stream
# start), but the training loaders draw several segments per file: whole
# decoded files are cached, least recently used first out, bounded by their
# total samples.
_FLAC_CACHE: "collections.OrderedDict[str, Tuple[np.ndarray, int]]" = collections.OrderedDict()
_FLAC_CACHE_MAX_SAMPLES = 200_000_000  # ~800 MB float32
_FLAC_LOCK = threading.Lock()


def _flac_lib(path: str) -> ctypes.CDLL:
    lib = _native()
    if lib is None:
        raise ValueError(f"cannot decode {path!r}: FLAC needs the native audio library "
                         f"({native_status()})")
    return lib


def _flac_info(lib: ctypes.CDLL, path: str) -> Tuple[int, int, int]:
    frames, fs, ch = ctypes.c_long(), ctypes.c_int(), ctypes.c_int()
    rc = lib.aio_flac_info(path.encode(), ctypes.byref(frames), ctypes.byref(fs),
                           ctypes.byref(ch))
    if rc != 0:
        raise ValueError(f"not a decodable FLAC file: {path!r} (rc={rc})")
    return frames.value, fs.value, ch.value


def _flac_full(path: str) -> Tuple[np.ndarray, int]:
    with _FLAC_LOCK:
        hit = _FLAC_CACHE.get(path)
        if hit is not None:
            _FLAC_CACHE.move_to_end(path)
            return hit
    lib = _flac_lib(path)
    frames, fs, _ = _flac_info(lib, path)
    out = np.zeros(frames, np.float32)
    got = lib.aio_flac_read_segment(path.encode(), 0, frames,
                                    out.ctypes.data_as(_c_float_p))
    if got < 0 or got < frames:
        raise ValueError(f"FLAC decode failed for {path!r} (got {got} of {frames} samples)")
    item = (out[:got], fs)
    with _FLAC_LOCK:
        while (_FLAC_CACHE and sum(a.size for a, _ in _FLAC_CACHE.values()) + got
               > _FLAC_CACHE_MAX_SAMPLES):
            _FLAC_CACHE.popitem(last=False)
        _FLAC_CACHE[path] = item
    return item


def _is_flac(path: str) -> bool:
    return path.lower().endswith(".flac")


def info(path: str) -> Tuple[int, int, int]:
    """(num_frames, sample_rate, channels) without decoding the whole file."""
    if _is_flac(path):
        return _flac_info(_flac_lib(path), path)
    lib = _native()
    if lib is not None and path.lower().endswith(".wav"):
        frames, fs, ch = ctypes.c_long(), ctypes.c_int(), ctypes.c_int()
        if lib.aio_read_info(path.encode(), ctypes.byref(frames), ctypes.byref(fs),
                             ctypes.byref(ch)) == 0:
            return frames.value, fs.value, ch.value
    with _wave.open(path, "rb") as w:
        return w.getnframes(), w.getframerate(), w.getnchannels()


def read(path: str, start: int = 0, frames: int = -1) -> Tuple[np.ndarray, int]:
    """Mono float32 [T] segment and sample rate; start and frames in samples
    (frames < 0: to the end). Channels are averaged."""
    if _is_flac(path):
        audio, fs = _flac_full(path)
        return (audio[start:] if frames < 0 else audio[start:start + frames]), fs
    lib = _native()
    if lib is not None and path.lower().endswith(".wav"):
        n_total, fs, _ = info(path)
        n = max(n_total - start if frames < 0 else min(frames, n_total - start), 0)
        out = np.zeros(n, np.float32)
        got = lib.aio_read_segment(path.encode(), start, n, out.ctypes.data_as(_c_float_p))
        if got >= 0:
            return out[:got], fs
    return _read_python(path, start, frames)


def _read_python(path: str, start: int, frames: int) -> Tuple[np.ndarray, int]:
    if not path.lower().endswith(".wav"):
        raise ValueError(f"cannot decode {path!r}: without the native audio library only "
                         "WAV is read")
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
    x = np.ascontiguousarray(np.asarray(audio, np.float32).reshape(-1))
    peak = float(np.max(np.abs(x))) if x.size else 0.0
    if normalize_if_clipping and peak > 1.0:
        x = x / peak
    lib = _native()
    if lib is not None and lib.aio_write_wav(path.encode(), x.ctypes.data_as(_c_float_p),
                                             x.size, int(fs)) == 0:
        return x
    with _wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(int(fs))
        w.writeframes((np.clip(x, -1, 1) * 32767.0).astype("<i2").tobytes())
    return x


def resample_host(x: np.ndarray, fs_in: float, fs_out: float) -> np.ndarray:
    """Host-side resampling: libsoxr through the native library where it
    answers, else ``scipy.signal.resample_poly`` (the JAX package's routes,
    in its order)."""
    if fs_in == fs_out:
        return np.asarray(x, np.float32)
    x = np.ascontiguousarray(x, np.float32)
    lib = _native()
    if lib is not None:
        out_len = int(np.ceil(x.size * fs_out / fs_in)) + 16
        out = np.zeros(out_len, np.float32)
        got = lib.aio_resample(x.ctypes.data_as(_c_float_p), x.size,
                               out.ctypes.data_as(_c_float_p), out_len,
                               float(fs_in), float(fs_out))
        if got > 0:
            return out[:got]
    import scipy.signal
    g = math.gcd(int(fs_in), int(fs_out))
    return scipy.signal.resample_poly(x, int(fs_out) // g, int(fs_in) // g).astype(np.float32)
