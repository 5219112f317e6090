"""One training iteration as a built program: the counterpart of the JAX
trainer's jitted, donated step and its ``compile_step``.

A ``StepProgram`` is built for one step's device inputs: the resampled
batch ``x`` [n_accum, B, L], the draws of each micro-batch (the polarity
``sign`` and ``gain_db`` where the augmentations draw them, ``sigma``, the
sigma-scaled ``noise``), each a static buffer with its own shape and dtype,
and a 0-dim slot for the EMA's keep factor (1 - rate, which the host
computes from the iteration count). It runs ``step(x, draws, ema_keep)``,
the trainer's micro-batch forward and backward passes, clipping, Adam, the
guardrails, the EMA and the metrics, over those buffers: nothing in it
draws from a generator or reads a number on the host.

On CUDA, building runs the step once on the device's capture stream
as its warm-up (``utils.graphs.warm_up``: the CQT and A-weighting tables
reach the device, every parameter gets a gradient). The warm-up really
updates the trainer's state, so the caller's ``restore`` puts it back
once the step is captured as one CUDA graph in a private memory pool
(``utils.graphs.capture``). ``run`` copies the inputs in, replays the graph and returns the
metrics as fresh tensors. A capture that fails raises with the operation
that broke it.

On the CPU ``run`` calls the same ``step`` eagerly over the same buffers.

Kernel launches: the Triton kernel's wrapper counts those a capture
records apart (``fused_adaln.captured_count``); each replay adds them.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch

from aid_tpu_torch.ops import fused_adaln as fa
from aid_tpu_torch.utils.graphs import Spec, capture, capture_stream, warm_up, zeros


def fresh(tree):
    """A copy of every tensor of a (nested dict of) metrics."""
    if isinstance(tree, dict):
        return {k: fresh(v) for k, v in tree.items()}
    return tree.clone()


class StepProgram:
    def __init__(self, step: Callable, buffers: Dict[str, Spec], device,
                 restore: Optional[Callable[[], None]] = None):
        """``step(x, draws, ema_keep) -> metrics``; ``buffers``: {name:
        (shape, dtype)} of "x" and of each draw; ``restore()`` undoes the
        warm-up's update of the trainer's state (CUDA only)."""
        if "x" not in buffers:
            raise ValueError(f"a step program needs the batch buffer 'x', got {sorted(buffers)}")
        self.step, self.device = step, torch.device(device)
        dev = self.device
        self.bufs = zeros(buffers, dev)
        self.ema_keep = torch.zeros((), dtype=torch.float32, device=dev)
        self.graph = None
        self.out = None
        self.launches = 0           # Triton launches per replay
        self.warmup_launches = 0
        self.pool_bytes = 0
        self.capture_s = 0.0
        self.replays = 0
        if dev.type == "cuda":
            self._capture(restore)
        elif dev.type != "cpu":
            raise ValueError(f"StepProgram: unsupported device {dev}")

    def _call(self):
        draws = {k: v for k, v in self.bufs.items() if k != "x"}
        return self.step(self.bufs["x"], draws, self.ema_keep)

    def _capture(self, restore) -> None:
        t0 = time.time()
        dev = self.device
        stream = capture_stream(dev)
        try:
            n0 = fa.launch_count()
            warm_up([self._call], stream)
            self.warmup_launches = fa.launch_count() - n0
            g, out, self.launches, self.pool_bytes = capture(
                self._call, stream, what=f"the training step at {self.shapes()}")
        finally:
            if restore is not None:
                restore()
        torch.cuda.synchronize(dev)
        # the warm-up's blocks, cached for its side stream, would stay reserved
        # beside the graph's pool (at full width tens of GB)
        torch.cuda.empty_cache()
        self.graph, self.out = g, out
        self.capture_s = time.time() - t0

    def run(self, x: torch.Tensor, draws: Dict[str, torch.Tensor], ema_keep: float) -> Dict:
        """One step on ``x`` and ``draws`` (the buffers' names and shapes)
        with the EMA keep factor ``ema_keep``; returns fresh metrics."""
        given = {"x": x, **draws}
        if set(given) != set(self.bufs):
            raise ValueError(f"the step program takes {sorted(self.bufs)}, got {sorted(given)}")
        for k, v in given.items():
            if tuple(v.shape) != tuple(self.bufs[k].shape):
                raise ValueError(f"{k} must be {tuple(self.bufs[k].shape)}, got "
                                 f"{tuple(v.shape)}")
        for k, v in given.items():
            self.bufs[k].copy_(v)
        self.ema_keep.fill_(float(ema_keep))
        if self.graph is None:
            return self._call()
        self.graph.replay()
        self.replays += 1
        fa.add_replayed_launches(self.launches)
        return fresh(self.out)

    # --------------------------------------------------------------- reports

    def shapes(self) -> Dict[str, list]:
        return {k: list(v.shape) for k, v in self.bufs.items()}

    def static_bytes(self) -> int:
        return sum(b.numel() * b.element_size() for b in (*self.bufs.values(), self.ema_keep))

    def memory_bytes(self) -> int:
        """Device bytes the program holds besides the trainer's state: its
        input buffers plus the peak its capture allocated in the graph pool
        (activations, gradients, the optimizer's temporaries). A program on
        the CPU holds no device memory: this raises."""
        if self.graph is None:
            raise RuntimeError(f"memory_bytes measures CUDA memory; this program runs "
                               f"eagerly on {self.device}")
        return self.static_bytes() + self.pool_bytes

    def report(self) -> dict:
        return {"shapes": self.shapes(), "graph": self.graph is not None,
                "capture_s": self.capture_s,
                "memory_bytes": self.memory_bytes() if self.graph is not None else None,
                "static_bytes": self.static_bytes(), "pool_bytes": self.pool_bytes,
                "launches_per_replay": self.launches, "warmup_launches": self.warmup_launches,
                "replays": self.replays}
