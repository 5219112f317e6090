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

A step whose collective a capture cannot hold (a dp step's gradient
all-reduce over gloo) is given as two functions and a ``hook`` between
them: ``head(x, draws) -> carry``, the forward and backward passes ending
in one flat buffer; ``hook(carry)``, the all-reduce, in place; and
``tail(carry, ema_keep) -> metrics``, the update. Each function is a graph
of its own in one memory pool, and the hook runs eagerly between their
replays.

On CUDA, building runs the step once on the device's capture stream
as its warm-up (``utils.graphs.warm_up``: the CQT and A-weighting tables
reach the device, every parameter gets a gradient, NCCL makes its
communicator: a collective's first call cannot be captured). The warm-up
really updates the trainer's state, so the caller's ``restore`` puts it
back once the step is captured as CUDA graphs in a private memory pool
(``utils.graphs.capture``). ``run`` copies the inputs in, replays the
graphs and returns the metrics as fresh tensors. A capture that fails
raises with the operation that broke it.

On the CPU ``run`` calls the same functions eagerly over the same buffers.

Kernel launches: the Triton kernels' wrappers count those a capture
records apart (``trace.Launches``); each replay adds them.

Tracing (``utils.trace``): the span ``program.build`` around the build
(``program.warm_up`` and ``program.capture`` inside it; ``report()`` gives
``capture_s``, ``warm_up_s`` and ``graph_capture_s``) and ``train.replay``
around the replay (the eager call on the CPU); the phase marks the step
makes (the trainer's ``train.forward``, ``train.backward`` and
``train.update``) are ``marks``'s, read after a replay.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from aid_tpu_torch.ops import fused_adaln as fa
from aid_tpu_torch.utils import trace
from aid_tpu_torch.utils.graphs import Spec, capture, capture_stream, warm_up, zeros


def fresh(tree):
    """A copy of every tensor of a (nested dict of) metrics."""
    if isinstance(tree, dict):
        return {k: fresh(v) for k, v in tree.items()}
    return tree.clone()


class StepProgram:
    def __init__(self, step, buffers: Dict[str, Spec], device,
                 restore: Optional[Callable[[], None]] = None,
                 hook: Optional[Callable[[torch.Tensor], None]] = None):
        """``step(x, draws, ema_keep) -> metrics``, or with ``hook`` the pair
        ``(head, tail)`` around it (the module's docstring); ``buffers``:
        {name: (shape, dtype)} of "x" and of each draw; ``restore()`` undoes
        the warm-up's update of the trainer's state (CUDA only)."""
        if "x" not in buffers:
            raise ValueError(f"a step program needs the batch buffer 'x', got {sorted(buffers)}")
        self.step, self.hook, self.device = step, hook, torch.device(device)
        dev = self.device
        self.bufs = zeros(buffers, dev)
        self.ema_keep = torch.zeros((), dtype=torch.float32, device=dev)
        self.graphs = []            # the step's graph, or the head's and the tail's
        self.carry = None           # the head graph's output, which the hook reduces
        self.out = None
        self.recorded = {}          # {kernel: (fwd, bwd) launches} per replay
        self.warmup_launches = 0
        self.pool_bytes = 0
        self.warm_up_s = 0.0
        self.replays = 0
        # the step's phase marks (the trainer's train.forward, .backward, .update)
        self.marks = trace.Marks("train.step")
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(f"StepProgram: unsupported device {dev}")
        with trace.span("program.build") as build:     # on the CPU nothing to build
            if dev.type == "cuda":
                self._capture(restore)
        self.capture_s = build.seconds if self.graphs else 0.0

    def _draws(self) -> Dict[str, torch.Tensor]:
        return {k: v for k, v in self.bufs.items() if k != "x"}

    def _call(self):
        """The whole step, eagerly (the hook between head and tail)."""
        if self.hook is None:
            return self.step(self.bufs["x"], self._draws(), self.ema_keep)
        head, tail = self.step
        carry = head(self.bufs["x"], self._draws())
        self.hook(carry)
        return tail(carry, self.ema_keep)

    def _capture(self, restore) -> None:
        dev = self.device
        stream = capture_stream(dev)
        what = f"the training step at {self.shapes()}"
        try:
            n0 = fa.launch_count()
            self.warm_up_s = warm_up([self._call], stream)
            self.warmup_launches = fa.launch_count() - n0
            if self.hook is None:
                g, self.out, self.recorded, self.pool_bytes = capture(
                    self._call, stream, what=what, marks=self.marks)
                self.graphs = [g]
            else:
                head, tail = self.step
                pool = torch.cuda.graph_pool_handle()
                base = torch.cuda.memory_allocated(dev)
                ga, carry, la, peak_a = capture(lambda: head(self.bufs["x"], self._draws()),
                                                stream, pool, what=f"the head of {what}",
                                                marks=self.marks)
                held = torch.cuda.memory_allocated(dev) - base   # what the tail finds live
                gb, self.out, lb, peak_b = capture(lambda: tail(carry, self.ema_keep), stream,
                                                   pool, what=f"the tail of {what}",
                                                   marks=self.marks)
                self.graphs, self.carry = [ga, gb], carry
                self.recorded = {k: tuple(a + b for a, b in zip(la.get(k, (0, 0)), n))
                                 for k, n in lb.items()}
                self.pool_bytes = max(peak_a, held + peak_b)
        finally:
            if restore is not None:
                restore()
        torch.cuda.synchronize(dev)
        # the warm-up's blocks, cached for its side stream, would stay reserved
        # beside the graph's pool (at full width tens of GB)
        torch.cuda.empty_cache()

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
        with trace.span("train.replay"):       # on the CPU the eager call
            if not self.graphs:
                return self._call()
            self.graphs[0].replay()
            if self.hook is not None:
                self.hook(self.carry)
                self.graphs[1].replay()
        self.marks.replayed()
        self.replays += 1
        trace.replayed_launches(self.recorded)
        return fresh(self.out)

    # --------------------------------------------------------------- reports

    def replay_launches(self, bwd: bool = False, kernel: str = "fused_adaln") -> int:
        """Forward (``bwd``: backward) launches of ``kernel`` a replay makes
        (0 on the CPU)."""
        return self.recorded.get(kernel, (0, 0))[int(bwd)]

    def shapes(self) -> Dict[str, list]:
        return {k: list(v.shape) for k, v in self.bufs.items()}

    def static_bytes(self) -> int:
        return sum(b.numel() * b.element_size() for b in (*self.bufs.values(), self.ema_keep))

    def memory_bytes(self) -> int:
        """Device bytes the program holds besides the trainer's state: its
        input buffers plus the peak its captures allocated in the graph pool
        (activations, gradients, the optimizer's temporaries; with two
        graphs the larger of the head's peak and what it leaves live plus
        the tail's peak). A program on
        the CPU holds no device memory: this raises."""
        if not self.graphs:
            raise RuntimeError(f"memory_bytes measures CUDA memory; this program runs "
                               f"eagerly on {self.device}")
        return self.static_bytes() + self.pool_bytes

    def report(self) -> dict:
        return {"shapes": self.shapes(), "graph": bool(self.graphs),
                "graphs": len(self.graphs), "hook": self.hook is not None,
                "capture_s": self.capture_s, "warm_up_s": self.warm_up_s,
                "graph_capture_s": self.capture_s - self.warm_up_s,
                "memory_bytes": self.memory_bytes() if self.graphs else None,
                "static_bytes": self.static_bytes(), "pool_bytes": self.pool_bytes,
                "launches_per_replay": self.replay_launches(),
                "bwd_launches_per_replay": self.replay_launches(bwd=True),
                "warmup_launches": self.warmup_launches,
                "replays": self.replays}
