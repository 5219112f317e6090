"""The guided-Heun trajectory as one built program: the counterpart of the
JAX package's ``jax.jit(...).lower(...).compile()`` of its sampler.

A ``HeunProgram`` is built for one task, batch, length, dtype and sampler
config. It owns static buffers (the trajectory's x, the observation y, the
mask and the smoothed mask, and the per-step slots t_i, t_next, gamma_i and
the churn row) and a score closure built over them, so each request reads
its own data from the same addresses. Its two steps are ``heun.heun_body``
and ``heun.heun_last``, the functions ``heun_sample`` loops over.

On CUDA, building warms both steps up on a side stream (the Triton
kernel's variants compile, cuFFT makes its plans, cuDNN picks its
algorithms, the CQT and resampler tables reach the device) and captures
each as a CUDA graph into a memory pool the caller's programs share (the
capture resets the device's peak-memory statistics to measure its pool).
``run`` copies a request in, replays ``body`` T - 1 times with each step's
values copied into the slots, replays ``last``, applies the final
projection where the config asks for it and returns a fresh tensor. A
capture that fails raises with the operation that broke it.

On the CPU the same object runs the same step functions eagerly over the
same buffers: its result is ``heun_sample``'s bit for bit.

Kernel launches: the Triton kernel's wrapper counts the launches a capture
records apart from real ones (``fused_adaln.captured_count``); each replay
adds what its graph recorded to the launch count.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

import torch

from aid_tpu_torch.diffusion import edm
from aid_tpu_torch.ops import fused_adaln as fa
from aid_tpu_torch.sampling import degradations as degr
from aid_tpu_torch.sampling.heun import SamplerConfig, heun_body, heun_last, make_score_fn

TASKS = ("inpainting", "unconditional")


class HeunProgram:
    def __init__(self, task: str, p: edm.EDMParams, cfg: SamplerConfig,
                 denoise: Callable, shape: Tuple[int, int], dtypes: Dict[str, torch.dtype],
                 device, hpf: Optional[Callable] = None, pool=None,
                 stream: Optional["torch.cuda.Stream"] = None):
        """task: "inpainting" (guided or replacement, by ``cfg.xi``, with
        the time-mask degradation and the smoothed-mask projection) or
        "unconditional"; denoise(x, t) and hpf as for ``make_score_fn``;
        ``dtypes``: the dtype of each input buffer, "x" (the prior), "z"
        (the churn) and, for inpainting, "y", "mask" and "smooth"; on CUDA,
        ``pool`` (``torch.cuda.graph_pool_handle()``) and ``stream`` are
        the capture's memory pool and side stream."""
        if task not in TASKS:
            raise ValueError(f"task must be one of {TASKS}, got {task!r}")
        if cfg.record:
            raise ValueError("a program does not record trajectories (rid mode runs eagerly)")
        self.task, self.p, self.cfg = task, p, cfg
        self.shape, self.device = tuple(shape), torch.device(device)
        dev = self.device
        self.t = edm.create_schedule(p, cfg.T, device=dev)
        self.gamma = edm.get_gamma(p, self.t[:-1])
        buf = lambda k: torch.zeros(self.shape, dtype=dtypes[k], device=dev)   # noqa: E731
        self.x, self.z = buf("x"), buf("z")
        self.t_i, self.t_next, self.g = (torch.zeros_like(self.t[0]) for _ in range(3))
        if task == "inpainting":
            self.y, self.mask, self.smooth = buf("y"), buf("mask"), buf("smooth")
            self.proj = degr.inpainting_projector(self.y, self.smooth)
            self.score = make_score_fn(p, cfg, denoise, y=self.y,
                                       degradation=degr.time_mask(self.mask),
                                       proj=self.proj, hpf=hpf)
        else:
            self.proj = None
            self.score = make_score_fn(p, cfg, denoise, hpf=hpf)
        self.graphs = None
        self.scores = {"body": 2 if cfg.order == 2 else 1, "last": 1}   # per step
        self.launches = {"body": 0, "last": 0}     # Triton launches per replay
        self.pool_bytes = 0
        self.capture_s = 0.0
        self.replays = 0
        if dev.type == "cuda":
            self._capture(pool, stream)
        elif dev.type != "cpu":
            raise ValueError(f"HeunProgram: unsupported device {dev}")

    # ----------------------------------------------------------------- steps

    def _body(self) -> None:
        x, _ = heun_body(self.p, self.cfg, self.score, self.x, self.t_i, self.t_next,
                         self.g, self.z)
        self.x.copy_(x)

    def _last(self) -> None:
        x, _ = heun_last(self.p, self.cfg, self.score, self.x, self.t_i, self.t_next,
                         self.g, self.z)
        self.x.copy_(x)

    def _set_step(self, i: int, churn: torch.Tensor) -> None:
        self.t_i.copy_(self.t[i])
        self.t_next.copy_(self.t[i + 1])
        self.g.copy_(self.gamma[i])
        self.z.copy_(churn[i])

    # --------------------------------------------------------------- capture

    def _capture(self, pool, stream) -> None:
        t0 = time.time()
        dev = self.device
        stream = stream if stream is not None else torch.cuda.Stream(dev)
        pool = pool if pool is not None else torch.cuda.graph_pool_handle()
        steps = (("body", self._body), ("last", self._last))
        self.t_i.copy_(self.t[0])
        self.t_next.copy_(self.t[1])
        self.g.copy_(self.gamma[0])
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            for _, fn in steps:                    # warm-up, eagerly
                fn()
        torch.cuda.current_stream(dev).wait_stream(stream)
        torch.cuda.synchronize(dev)
        graphs = {}
        for name, fn in steps:
            g = torch.cuda.CUDAGraph()
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            n0 = fa.captured_count()
            try:
                with torch.cuda.graph(g, pool=pool, stream=stream):
                    fn()
            except Exception as e:
                raise RuntimeError(f"CUDA graph capture of the {self.task} program's "
                                   f"'{name}' step at {self.shape} failed: {e!r}") from e
            self.launches[name] = fa.captured_count() - n0
            self.pool_bytes = max(self.pool_bytes,
                                  torch.cuda.max_memory_allocated(dev) - base)
            graphs[name] = g
        torch.cuda.synchronize(dev)
        self.graphs = graphs
        self.capture_s = time.time() - t0

    def _step(self, name: str) -> None:
        if self.graphs is None:
            (self._body if name == "body" else self._last)()
            return
        self.graphs[name].replay()
        self.replays += 1
        fa.add_replayed_launches(self.launches[name])

    # ------------------------------------------------------------------- run

    def run(self, prior: torch.Tensor, churn: torch.Tensor, y: Optional[torch.Tensor] = None,
            mask: Optional[torch.Tensor] = None,
            smooth: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One trajectory from the standard-normal ``prior`` [B, L] and
        ``churn`` [T, B, L]; for inpainting, the masked observation ``y``,
        its ``mask`` and the projection's ``smooth`` mask, all [B, L].
        Returns a new tensor."""
        T = self.cfg.T
        if tuple(prior.shape) != self.shape or tuple(churn.shape) != (T,) + self.shape:
            raise ValueError(f"noise shapes prior {tuple(prior.shape)}, churn "
                             f"{tuple(churn.shape)} do not fit {self.shape} x T={T}")
        if self.task == "inpainting":
            for name, v in (("y", y), ("mask", mask), ("smooth", smooth)):
                if v is None or tuple(v.shape) != self.shape:
                    raise ValueError(f"{name} must be {self.shape}, got "
                                     f"{None if v is None else tuple(v.shape)}")
            self.y.copy_(y)
            self.mask.copy_(mask)
            self.smooth.copy_(smooth)
        self.x.copy_(prior * self.t[0])
        for i in range(T - 1):
            self._set_step(i, churn)
            self._step("body")
        self._set_step(T - 1, churn)
        self._step("last")
        if self.cfg.data_consistency_end and self.proj is not None:
            return self.proj(self.x)
        return self.x.clone()

    # --------------------------------------------------------------- reports

    def static_bytes(self) -> int:
        bufs = [self.x, self.z, self.t_i, self.t_next, self.g, self.t, self.gamma]
        if self.task == "inpainting":
            bufs += [self.y, self.mask, self.smooth]
        return sum(b.numel() * b.element_size() for b in bufs)

    def memory_bytes(self) -> int:
        """Device bytes the program holds: its static buffers plus the peak
        its larger captured step allocated in the graph pool. The
        counterpart of XLA's ``memory_analysis()``, without the weights.
        A program on the CPU holds no device memory: this raises."""
        if self.graphs is None:
            raise RuntimeError(f"memory_bytes measures CUDA memory; this program runs "
                               f"eagerly on {self.device}")
        return self.static_bytes() + self.pool_bytes

    def launches_per_run(self) -> int:
        """Triton launches one ``run`` makes: what each capture recorded,
        times its replays (0 on the CPU)."""
        return self.launches["body"] * (self.cfg.T - 1) + self.launches["last"]

    def scores_per_run(self) -> int:
        """Score (denoiser) evaluations of one ``run``."""
        return self.scores["body"] * (self.cfg.T - 1) + self.scores["last"]

    def report(self) -> dict:
        return {"task": self.task, "shape": list(self.shape), "T": self.cfg.T,
                "order": self.cfg.order, "graphs": self.graphs is not None,
                "capture_s": self.capture_s,
                "memory_bytes": self.memory_bytes() if self.graphs is not None else None,
                "static_bytes": self.static_bytes(), "pool_bytes": self.pool_bytes,
                "scores": dict(self.scores), "scores_per_run": self.scores_per_run(),
                "launches_per_replay": dict(self.launches),
                "launches_per_run": self.launches_per_run(), "replays": self.replays}
