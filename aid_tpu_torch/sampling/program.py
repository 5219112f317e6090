"""The guided-Heun trajectory as one built program: the counterpart of the
JAX package's ``jax.jit(...).lower(...).compile()`` of its sampler, for
every task and for ``rid`` recording.

A ``Task`` names what a sampler task reads: its inputs (each a static
buffer with its own shape and dtype) and ``ops``, which builds the task's
observation, degradation and projections over those buffers. Its ``key``
is the JAX package's program key (``Sampler._cached_program``): what is a
traced argument there (the mask, the clip value, the observation) is a
buffer here, so a new value never builds a new program; what is static
there (the BWE filter, phase retrieval's shape) is in the key. The seven
tasks are the functions below.

A ``HeunProgram`` is built for one task, the shapes and dtypes of its
buffers, one sampler config and device. It owns the buffers (the
trajectory's x, the churn row z, the task's inputs, the per-step slots
t_i, t_next, gamma_i and the step index, and with ``cfg.record`` six
``[T, B, L]`` record buffers) and a score closure built over them, so each
request reads its own data from the same addresses. Its two steps are
``heun.heun_body`` and ``heun.heun_last``, the functions ``heun_sample``
loops over; under ``cfg.record`` each writes its step's Record at the
step index (``heun.write_record``).

On CUDA, building warms both steps up on the device's one capture stream
(``utils.graphs.warm_up``: the CQT, window, filter and resampler tables
reach the device) and captures each as a CUDA graph
(``utils.graphs.capture``) into a memory pool the caller's programs
share. ``run`` copies a
request in, replays ``body`` T - 1 times with each step's values copied
into the slots, replays ``last``, applies the final projection where the
config asks for it and returns fresh tensors (x, or (x, Record) when
recording). A capture that fails raises with the task, the step and the
operation that broke it.

On the CPU the same object runs the same step functions eagerly over the
same buffers: its result is ``heun_sample``'s bit for bit.

Kernel launches: the Triton kernel's wrapper counts the launches a capture
records apart from real ones (``fused_adaln.captured_count``); each replay
adds what its graph recorded to the launch count.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from aid_tpu_torch.diffusion import edm
from aid_tpu_torch.ops import fused_adaln as fa
from aid_tpu_torch.sampling import degradations as degr
from aid_tpu_torch.sampling.heun import (Record, SamplerConfig, heun_body, heun_last,
                                         make_score_fn, write_record)
from aid_tpu_torch.utils.graphs import Spec, capture, capture_stream, warm_up, zeros


class Ops(NamedTuple):
    """A task's operators: the observation ``y`` the guidance compares with
    (None: unconditional), the degradation, the per-step projection and the
    final one."""
    y: Optional[torch.Tensor] = None
    degradation: Optional[Callable] = None
    proj: Optional[Callable] = None
    proj_end: Optional[Callable] = None


class Task(NamedTuple):
    """A sampler task: its name, the JAX package's program key, the names
    of its inputs and ``ops(inputs) -> Ops`` over a dict of them."""
    name: str
    key: tuple
    inputs: Tuple[str, ...]
    ops: Callable[[Dict[str, torch.Tensor]], Ops]


def inpainting() -> Task:
    """Time-mask inpainting (guided or replacement, by ``cfg.xi``): the
    observation ``y``, its ``mask`` and the projection's ``smooth`` mask."""
    def ops(b):
        proj = degr.inpainting_projector(b["y"], b["smooth"])
        return Ops(b["y"], degr.time_mask(b["mask"]), proj, proj)
    return Task("inpainting", ("inpainting",), ("y", "mask", "smooth"), ops)


def unconditional() -> Task:
    return Task("unconditional", ("unconditional",), (), lambda b: Ops())


def spectrogram_inpainting(stft_cfg) -> Task:
    """An (F, frames) STFT-domain ``mask_FT``: the degradation is the masked
    resynthesis A, the projection y + x - A(x)."""
    def ops(b):
        apply = degr.spectral_mask(b["mask_FT"], stft_cfg)
        proj = degr.spectral_projector(b["y"], apply)
        return Ops(b["y"], apply, proj, proj)
    return Task("spectrogram_inpainting", ("spec_inpaint",), ("y", "mask_FT"), ops)


def bwe(filter_type: str, order: int, fc: float, fs: float) -> Task:
    """Bandwidth extension: the degradation is the lowpass LPF, the
    projection y + x - LPF(x); the filter is part of the key."""
    def ops(b):
        lpf = degr.bwe_lowpass(filter_type, order, fc, fs)
        proj = degr.spectral_projector(b["y"], lpf)
        return Ops(b["y"], lpf, proj, proj)
    return Task("bwe", ("bwe", str(filter_type), float(fc), float(fs), int(order)), ("y",), ops)


def declipping() -> Task:
    """Guidance through the hard clip at the 0-dim ``clip_value``."""
    return Task("declipping", ("declip",), ("y", "clip_value"),
                lambda b: Ops(b["y"], degr.hard_clip(b["clip_value"])))


def phase_retrieval(shape, stft_cfg) -> Task:
    """Guidance through |STFT(x)| against ``y_mag`` [B, F, frames]."""
    return Task("phase_retrieval", ("phase", tuple(shape)), ("y_mag",),
                lambda b: Ops(b["y_mag"], degr.stft_magnitude(stft_cfg)))


def compsens() -> Task:
    """Guidance through the random sample ``mask``, no projection."""
    return Task("compsens", ("compsens",), ("y", "mask"),
                lambda b: Ops(b["y"], degr.time_mask(b["mask"])))


class HeunProgram:
    def __init__(self, task: Task, p: edm.EDMParams, cfg: SamplerConfig,
                 denoise: Callable, buffers: Dict[str, Spec], device,
                 hpf: Optional[Callable] = None, pool=None,
                 stream: Optional["torch.cuda.Stream"] = None):
        """``buffers``: {name: (shape, dtype)} of "x" (the prior; its shape
        is the trajectory's [B, L]), "z" (the churn row, the same shape) and
        every input of ``task``; denoise(x, t) and hpf as for
        ``make_score_fn``; on CUDA, ``pool``
        (``torch.cuda.graph_pool_handle()``) and ``stream`` (by default the
        device's ``utils.graphs.capture_stream``) are the capture's memory
        pool and side stream."""
        names = {"x", "z", *task.inputs}
        if set(buffers) != names:
            raise ValueError(f"the {task.name} program needs the buffers {sorted(names)}, "
                             f"got {sorted(buffers)}")
        self.task, self.key, self.p, self.cfg = task.name, task.key, p, cfg
        self.inputs = task.inputs
        self.shape, self.device = tuple(buffers["x"][0]), torch.device(device)
        if tuple(buffers["z"][0]) != self.shape:
            raise ValueError(f"churn row {buffers['z'][0]} does not fit x {self.shape}")
        dev = self.device
        self.t = edm.create_schedule(p, cfg.T, device=dev)
        self.gamma = edm.get_gamma(p, self.t[:-1])
        self.steps = torch.arange(cfg.T, device=dev)
        self.bufs = zeros(buffers, dev)
        self.x, self.z = self.bufs["x"], self.bufs["z"]
        self.t_i, self.t_next, self.g = (torch.zeros_like(self.t[0]) for _ in range(3))
        self.i = torch.zeros_like(self.steps[0])
        self.records: Optional[Record] = None     # [T, B, L] each, made by the first step
        self.ops = task.ops({k: self.bufs[k] for k in task.inputs})
        # the denoiser calls of the steps, counted (the closure holds a
        # list, never the program, which is freed by reference counting)
        calls = self._calls = [0]

        def counted(x, t):
            calls[0] += 1
            return denoise(x, t)

        self.score = make_score_fn(p, cfg, counted, y=self.ops.y,
                                   degradation=self.ops.degradation, proj=self.ops.proj,
                                   hpf=hpf)
        self.graphs = None
        # denoiser calls per step: the order's, until a capture counts those
        # its graph records
        self.scores = {"body": 2 if cfg.order == 2 else 1, "last": 1}
        self.replayed_scores = 0                   # denoiser calls the replays ran
        self.launches = {"body": 0, "last": 0}     # Triton launches per replay
        self.pool_bytes = 0
        self.capture_s = 0.0
        self.replays = 0
        if dev.type == "cuda":
            self._capture(pool, stream)
        elif dev.type != "cpu":
            raise ValueError(f"HeunProgram: unsupported device {dev}")

    # ----------------------------------------------------------------- steps

    def _record(self, rec: Optional[Record], x: torch.Tensor) -> None:
        if not self.cfg.record:
            return
        rec = rec._replace(xt2=x)
        if self.records is None:
            self.records = Record(*(torch.zeros((self.cfg.T,) + tuple(f.shape), dtype=f.dtype,
                                                device=self.device) for f in rec))
        write_record(self.records, self.i, rec)

    def _body(self) -> None:
        x, rec = heun_body(self.p, self.cfg, self.score, self.x, self.t_i, self.t_next,
                           self.g, self.z)
        self._record(rec, x)
        self.x.copy_(x)

    def _last(self) -> None:
        x, rec = heun_last(self.p, self.cfg, self.score, self.x, self.t_i, self.t_next,
                           self.g, self.z)
        self._record(rec, x)
        self.x.copy_(x)

    def _set_step(self, i: int, churn: torch.Tensor) -> None:
        self.t_i.copy_(self.t[i])
        self.t_next.copy_(self.t[i + 1])
        self.g.copy_(self.gamma[i])
        self.i.copy_(self.steps[i])
        self.z.copy_(churn[i])

    # --------------------------------------------------------------- capture

    def _capture(self, pool, stream) -> None:
        t0 = time.time()
        dev = self.device
        stream = stream if stream is not None else capture_stream(dev)
        pool = pool if pool is not None else torch.cuda.graph_pool_handle()
        steps = (("body", self._body), ("last", self._last))
        self.t_i.copy_(self.t[0])
        self.t_next.copy_(self.t[1])
        self.g.copy_(self.gamma[0])
        warm_up([fn for _, fn in steps], stream)
        graphs = {}
        for name, fn in steps:
            n0 = self._calls[0]
            graphs[name], _, self.launches[name], peak = capture(
                fn, stream, pool, f"the {self.task} program's '{name}' step at {self.shape}")
            self.scores[name] = self._calls[0] - n0
            self.pool_bytes = max(self.pool_bytes, peak)
        torch.cuda.synchronize(dev)
        self.graphs = graphs
        self.capture_s = time.time() - t0

    def _step(self, name: str) -> None:
        if self.graphs is None:
            (self._body if name == "body" else self._last)()
            return
        self.graphs[name].replay()
        self.replays += 1
        self.replayed_scores += self.scores[name]
        fa.add_replayed_launches(self.launches[name])

    # ------------------------------------------------------------------- run

    def run(self, prior: torch.Tensor, churn: torch.Tensor, **inputs: torch.Tensor):
        """One trajectory from the standard-normal ``prior`` [B, L] and
        ``churn`` [T, B, L], and the task's ``inputs`` by name. Returns a new
        tensor, or (x, Record) of new tensors when the config records."""
        T = self.cfg.T
        if tuple(prior.shape) != self.shape or tuple(churn.shape) != (T,) + self.shape:
            raise ValueError(f"noise shapes prior {tuple(prior.shape)}, churn "
                             f"{tuple(churn.shape)} do not fit {self.shape} x T={T}")
        if set(inputs) != set(self.inputs):
            raise ValueError(f"the {self.task} program takes the inputs {list(self.inputs)}, "
                             f"got {sorted(inputs)}")
        for name, v in inputs.items():
            buf = self.bufs[name]
            if v is None or tuple(v.shape) != tuple(buf.shape):
                raise ValueError(f"{name} must be {tuple(buf.shape)}, got "
                                 f"{None if v is None else tuple(v.shape)}")
        for name, v in inputs.items():
            self.bufs[name].copy_(v)
        self.x.copy_(prior * self.t[0])
        for i in range(T - 1):
            self._set_step(i, churn)
            self._step("body")
        self._set_step(T - 1, churn)
        self._step("last")
        if self.cfg.data_consistency_end and self.ops.proj_end is not None:
            x = self.ops.proj_end(self.x)
        else:
            x = self.x.clone()
        if self.cfg.record:
            return x, Record(*(r.clone() for r in self.records))
        return x

    # --------------------------------------------------------------- reports

    def static_bytes(self) -> int:
        bufs = [*self.bufs.values(), self.t_i, self.t_next, self.g, self.i, self.t,
                self.gamma, self.steps, *(self.records or ())]
        return sum(b.numel() * b.element_size() for b in bufs)

    def memory_bytes(self) -> int:
        """Device bytes the program holds: its static buffers (the record
        buffers included) plus the peak its larger captured step allocated
        in the graph pool. The counterpart of XLA's ``memory_analysis()``,
        without the weights. A program on the CPU holds no device memory:
        this raises."""
        if self.graphs is None:
            raise RuntimeError(f"memory_bytes measures CUDA memory; this program runs "
                               f"eagerly on {self.device}")
        return self.static_bytes() + self.pool_bytes

    def launches_per_run(self) -> int:
        """Triton launches one ``run`` makes: what each capture recorded,
        times its replays (0 on the CPU)."""
        return self.launches["body"] * (self.cfg.T - 1) + self.launches["last"]

    def scores_per_run(self) -> int:
        """Score (denoiser) evaluations of one ``run`` (on CUDA, as its
        captures counted them)."""
        return self.scores["body"] * (self.cfg.T - 1) + self.scores["last"]

    def report(self) -> dict:
        return {"task": self.task, "key": list(self.key), "shape": list(self.shape),
                "T": self.cfg.T, "order": self.cfg.order, "record": self.cfg.record,
                "graphs": self.graphs is not None, "capture_s": self.capture_s,
                "memory_bytes": self.memory_bytes() if self.graphs is not None else None,
                "static_bytes": self.static_bytes(), "pool_bytes": self.pool_bytes,
                "scores": dict(self.scores), "scores_per_run": self.scores_per_run(),
                "launches_per_replay": dict(self.launches),
                "launches_per_run": self.launches_per_run(), "replays": self.replays,
                "replayed_scores": self.replayed_scores}
