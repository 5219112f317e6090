"""The JAX package's native audio library, loaded reliably for the port's
tests.

``aid_tpu.data.audio_io._native`` builds ``aid_tpu/native/libaudioio.so``
in place (``g++ -o <final path>``) the first time it finds it missing, and
loads it once per process. Under several test workers a second process can
find the half-written file and fail to load it (``OSError: ... file too
short``); ``_native`` has marked itself tried by then and returns ``None``
for the rest of that process. ``build_and_load`` takes a lock file for the
whole step, builds a missing library into a private temporary file that it
moves into place with ``os.replace`` (a reader never sees a partial file),
and retries a failed load with a short back-off while another process may
still be writing the file in place. ``jax_native`` does that for the JAX
package's own directory and loader.
"""
import ctypes
import fcntl
import os
import subprocess
import tempfile
import time
from typing import Callable, Optional

LIB = "libaudioio.so"
SOURCES = ("audioio.cpp", "flac.cpp")
JAX_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                              "aid_tpu", "native")


def build(native_dir: str) -> str:
    """Compile ``native_dir``'s sources with the JAX package's g++ command
    into a temporary file there, then move it into place atomically.
    Returns the library's path."""
    path = os.path.join(native_dir, LIB)
    fd, tmp = tempfile.mkstemp(prefix=".libaudioio-", suffix=".so.tmp", dir=native_dir)
    os.close(fd)
    try:
        subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-o", tmp,
                        *(os.path.join(native_dir, s) for s in SOURCES), "-ldl"],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def build_and_load(native_dir: str, load: Optional[Callable] = None,
                   timeout_s: float = 60.0):
    """The library of ``native_dir``, built there if missing and loaded by
    ``load()`` (default: ``ctypes.CDLL`` of the file), under an exclusive
    lock on ``native_dir/.libaudioio.lock``. A load that raises ``OSError``
    or returns ``None`` is retried with a back-off of 0.05 s doubling to
    1 s, for up to ``timeout_s``; then the last error is raised."""
    path = os.path.join(native_dir, LIB)
    load = load or (lambda: ctypes.CDLL(path))
    with open(os.path.join(native_dir, ".libaudioio.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not os.path.exists(path):
                build(native_dir)
            deadline, delay = time.monotonic() + timeout_s, 0.05
            while True:
                try:
                    lib = load()
                    if lib is not None:
                        return lib
                    err = OSError(f"{path}: the loader returned None")
                except OSError as e:        # another process is writing the file
                    err = e
                if time.monotonic() > deadline:
                    raise err
                time.sleep(delay)
                delay = min(2 * delay, 1.0)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def jax_native():
    """``aid_tpu.data.audio_io._native()``, loaded: a failed attempt resets
    the module's ``_NATIVE_TRIED`` and ``_NATIVE`` and is retried."""
    from aid_tpu.data import audio_io as jaudio

    def load():
        if jaudio._NATIVE is None:
            jaudio._NATIVE_TRIED = False
        return jaudio._native()

    return build_and_load(JAX_NATIVE_DIR, load)
