"""What the port's CUDA graph programs share: their static buffers, the side
stream their builds warm up and capture on, the capture itself, and what a
captured graph fixes (the tensors it reads, the settings its kernels were
chosen under).

Every build (``sampling.program.HeunProgram``, ``training.program.StepProgram``)
warms its functions up (``warm_up``) and captures each (``capture``) on
one side stream per device for the life of the process: a new stream per
build would give each its own per-stream resources (cuBLAS's workspace is
made on a stream's first matrix product and kept), and a long-lived block
made in the middle of a warm-up keeps the segment it was cut from
reserved.

No garbage collection runs during a capture. A program is freed by
reference counting when its owner drops it; a program that a reference
cycle keeps alive is freed by the collector instead, at whatever
allocation triggers it. On an H100 (PyTorch 2.11) a graph freed that way
in the middle of another graph's capture invalidated that capture ("operation
failed due to a previous error during capture" at its next launch).
"""
from __future__ import annotations

import contextlib
import gc
from typing import Callable, Dict, Optional, Tuple

import torch

from aid_tpu_torch.utils import trace

Spec = Tuple[Tuple[int, ...], torch.dtype]      # a buffer's shape and dtype

_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


def specs(tensors: Dict[str, torch.Tensor]) -> Dict[str, Spec]:
    """{name: (shape, dtype)} of ``tensors``."""
    return {k: (tuple(v.shape), v.dtype) for k, v in tensors.items()}


def zeros(buffers: Dict[str, Spec], device) -> Dict[str, torch.Tensor]:
    """A zero tensor of each (shape, dtype) of ``buffers`` on ``device``."""
    return {k: torch.zeros(tuple(s), dtype=d, device=device) for k, (s, d) in buffers.items()}


def capture_stream(device) -> "torch.cuda.Stream":
    """The side stream of every warm-up and capture on ``device``."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    s = _STREAMS.get(device)
    if s is None:
        s = _STREAMS[device] = torch.cuda.Stream(device)
    return s


def warm_up(fns, stream: "torch.cuda.Stream") -> float:
    """Run each of ``fns`` once, eagerly, on ``stream`` and wait for it: the
    Triton kernel's variants compile, cuFFT makes its plans, cuDNN picks
    its algorithms and every table reaches the device before a capture.
    Returns its seconds (the span ``program.warm_up``)."""
    dev = stream.device
    with trace.span("program.warm_up") as s:
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            for fn in fns:
                fn()
        torch.cuda.current_stream(dev).wait_stream(stream)
        torch.cuda.synchronize(dev)
    return s.seconds


def capture(fn: Callable, stream: "torch.cuda.Stream", pool=None, what: str = "a step",
            marks: Optional[trace.Marks] = None):
    """Capture ``fn()`` as one CUDA graph on ``stream`` into ``pool`` (a
    private pool when None), with the collector off, inside the span
    ``program.capture``; the phase marks ``fn`` makes are ``marks``'s. Returns
    (the graph, what ``fn`` returned, the {kernel: (forward, backward)}
    launches the capture recorded, which each replay adds with
    ``trace.replayed_launches``, the peak bytes it allocated in the pool;
    the device's peak-memory statistics are reset to measure it). A capture
    that fails raises, naming ``what``."""
    dev = stream.device
    g = torch.cuda.CUDAGraph()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    n0 = trace.captured_launches()
    collecting = gc.isenabled()
    gc.disable()
    try:
        with trace.span("program.capture"), \
                (marks.capturing() if marks is not None else contextlib.nullcontext()), \
                torch.cuda.graph(g, pool=pool, stream=stream):
            out = fn()
    except Exception as e:
        raise RuntimeError(f"CUDA graph capture of {what} failed: {e!r}") from e
    finally:
        if collecting:
            gc.enable()
    launches = trace.captured_launches(since=n0)
    return g, out, launches, torch.cuda.max_memory_allocated(dev) - base


def tensors_key(tensors) -> tuple:
    """Address, dtype and version of each tensor: a graph captured over
    them replays only while this is unchanged (a new tensor, a dtype cast,
    a move or an in-place load changes it)."""
    return tuple((t.data_ptr(), t.dtype, t._version) for t in tensors)


def capture_flags(model) -> tuple:
    """What a captured graph fixes besides its inputs: the TF32 and cuDNN
    switches its kernels were chosen under, and the model's remat setting."""
    return (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
            getattr(model, "remat", None), getattr(model, "remat_policy", None))

