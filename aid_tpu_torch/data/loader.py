"""Host-side batching and prefetching for the training iterators.

The port's own copy of ``aid_tpu/data/loader.py``: datasets yield
``(segment [T], fs)`` on the host; ``batched`` groups them into numpy
``([B, T], [B])`` batches, which a background thread (``Prefetcher``) or
decode worker processes (``MultiProcessLoader``) keep ready. The trainer
moves each batch to the card.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np


def batched(sample_iter: Iterator, batch_size: int):
    """Group an iterator of (segment [T], fs) into ([B, T], [B]) batches;
    shorter segments are zero-padded to the longest."""
    while True:
        xs, fss = [], []
        for _ in range(batch_size):
            x, fs = next(sample_iter)
            xs.append(np.asarray(x, np.float32))
            fss.append(fs)
        T = max(x.shape[-1] for x in xs)
        out = np.zeros((batch_size, T), np.float32)
        for i, x in enumerate(xs):
            out[i, :x.shape[-1]] = x
        yield out, np.asarray(fss, np.int64)


class Prefetcher:
    """Background-thread prefetch of a batch iterator (depth-bounded). An
    exception in the iterator is raised by the next ``next()``."""

    def __init__(self, it: Iterator, depth: int = 4):
        self._it = it
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        try:
            for item in self._it:
                self._q.put(item)
        except BaseException as e:  # handed to the consumer on its next()
            self._err = e
            self._q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            raise self._err if self._err else StopIteration
        return item


def make_train_loader(sample_iter: Iterator, batch_size: int, prefetch_depth: int = 4):
    return Prefetcher(batched(sample_iter, batch_size), depth=prefetch_depth)


# --------------------------------------------------------------------------
# Multi-process decode: worker processes each build the dataset from the
# pickled config and push finished batches through one queue. Workers decode
# with numpy only and must never touch CUDA: they start from a forkserver
# (no fork of a parent that holds a CUDA context) and hide every card before
# anything could initialise one.


def _worker_main(args, callable_name, worker_id, batch_size, q, rank=0):
    import os
    import traceback
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    try:
        from aid_tpu_torch.utils.containers import EasyDict
        from aid_tpu_torch.utils.registry import call_func_by_name
        args = EasyDict(args)
        # decorrelate workers and ranks: each draws from its own stream (a
        # worker has no process group, so its rank is handed over)
        args["exp"]["seed"] = (int(args["exp"].get("seed", 42)) + 1000003 * rank
                               + 7919 * (worker_id + 1))
        ds = call_func_by_name(args, func_name=callable_name)
        for item in batched(iter(ds), batch_size):
            q.put(("ok", item))
    except BaseException:  # reported to the trainer, which raises it
        q.put(("err", traceback.format_exc()))


class MultiProcessLoader:
    """N decode worker processes feeding one bounded batch queue. Batches
    arrive in completion order; each worker owns an independently seeded
    stream of the same dataset (and of this ``rank``'s)."""

    def __init__(self, args, callable_name: str, batch_size: int,
                 num_workers: int, prefetch_depth: int = 4, rank: int = 0):
        import copy
        import multiprocessing as mp
        ctx = mp.get_context("forkserver")
        self._q = ctx.Queue(maxsize=max(prefetch_depth, num_workers))
        self._procs = []
        for w in range(num_workers):
            p = ctx.Process(target=_worker_main,
                            args=(copy.deepcopy(dict(args)), callable_name, w,
                                  batch_size, self._q, rank),
                            daemon=True)
            p.start()
            self._procs.append(p)

    def __iter__(self):
        return self

    def __next__(self):
        status, payload = self._q.get()
        if status == "err":
            self.close()
            raise RuntimeError(f"data worker failed:\n{payload}")
        return payload

    def close(self):
        for p in self._procs:
            if p.is_alive():
                p.terminate()
        for p in self._procs:
            p.join(timeout=5)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
