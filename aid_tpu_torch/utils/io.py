"""Small I/O utilities: cached URL fetch and a stdout tee logger (the
port's own copy of ``aid_tpu/utils/io.py``; the reference's dnnlib
``open_url`` and ``Logger``)."""
from __future__ import annotations

import hashlib
import os
import sys
import urllib.request
from typing import Optional


def open_url(url: str, cache_dir: Optional[str] = None, timeout: float = 60.0):
    """An open binary file object for ``url``: a local path is opened as it
    is; a URL is downloaded once into ``cache_dir`` (default
    ``~/.cache/aid_tpu/downloads``) and read from there. Without network
    access a URL raises ``URLError``: pass a local path instead."""
    if os.path.exists(url):
        return open(url, "rb")
    cache_dir = cache_dir or os.path.join(
        os.path.expanduser("~"), ".cache", "aid_tpu", "downloads")
    os.makedirs(cache_dir, exist_ok=True)
    tag = hashlib.md5(url.encode()).hexdigest()[:16]
    name = os.path.basename(url.split("?")[0]) or "download"
    path = os.path.join(cache_dir, f"{tag}-{name}")
    if not os.path.exists(path):
        tmp = path + ".tmp"
        with urllib.request.urlopen(url, timeout=timeout) as r, open(tmp, "wb") as f:
            while True:
                chunk = r.read(1 << 20)
                if not chunk:
                    break
                f.write(chunk)
        os.replace(tmp, path)
    return open(path, "rb")


class Logger:
    """Tee stdout to a file (appended, flushed on every write) until
    ``close``."""

    def __init__(self, file_name: Optional[str] = None, file_mode: str = "a",
                 should_flush: bool = True):
        self.file = open(file_name, file_mode) if file_name else None
        self.should_flush = should_flush
        self.stdout = sys.stdout
        self.stderr = sys.stderr
        sys.stdout = self

    def write(self, text: str) -> None:
        if len(text) == 0:
            return
        if self.file is not None:
            self.file.write(text)
        self.stdout.write(text)
        if self.should_flush:
            self.flush()

    def flush(self) -> None:
        if self.file is not None:
            self.file.flush()
        self.stdout.flush()

    def close(self) -> None:
        self.flush()
        if sys.stdout is self:
            sys.stdout = self.stdout
        if self.file is not None:
            self.file.close()
            self.file = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
