"""The benchmark's one door into the program under test, ``aid_tpu_torch``:
its configuration composed from a configuration file's words and held to
the file's sizes, and its network built with the benchmark's weights.
"""
from __future__ import annotations

import gc
from typing import Dict, List

import torch

from reference.unet import param_shapes

import inputs


def compose(cfg: dict, role: str, control: bool = False):
    """The program's config tree for ``role`` ("serving" or "training"): the
    file's words, then the role's. Every size and setting the file states
    (``network``, ``exp`` and the role's ``stated`` groups) must be what the
    program composed. ``control`` adds the role's ``control`` words, the
    configuration's lower-precision path, after that check."""
    from aid_tpu_torch.utils.config import compose as port_compose
    words: List[str] = list(cfg["compose"]) + list(cfg[role]["compose"])
    args = port_compose(overrides=words)
    for group in ("network", "exp"):
        _same(cfg[group], args[group], group)
    for group, stated in cfg[role]["stated"].items():
        _same(stated, args[group], f"{role}: {group}")
    return port_compose(overrides=words + list(cfg[role]["control"])) if control else args


def _same(stated, composed, where: str) -> None:
    if isinstance(stated, dict):
        for k, v in stated.items():
            if k not in composed:
                raise ValueError(f"{where}.{k}: the program's config has no such key")
            _same(v, composed[k], f"{where}.{k}")
    elif (list(stated) if isinstance(stated, (list, tuple)) else stated) != \
            (list(composed) if isinstance(composed, (list, tuple)) else composed):
        raise ValueError(f"{where}: the configuration file states {stated!r}, "
                         f"the program composed {composed!r}")


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    return inputs.weights(param_shapes(cfg["network"]), seed, device)


def network(args, cfg: dict, seed: int, device, trainable: bool):
    """The program's network (``setup.setup_network``) with the benchmark's
    weights: frozen in the compute dtype for serving, float32 for training."""
    from aid_tpu_torch import setup as tsetup
    state = make_weights(cfg, seed, device)
    net = tsetup.setup_network(args, device=device, state_dict=state, trainable=trainable)
    del state
    return net


def free(device) -> None:
    """Let go of the program's memory before the reference runs."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


class Exact32:
    """float32 matrix products and convolutions without TF32, restored after."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved


def cached(cache, key, compute):
    """``compute()``, or what it gave for ``key`` before where ``cache`` (a
    dict a calibration passes in) holds it."""
    if cache is None:
        return compute()
    if key not in cache:
        cache[key] = compute()
    return cache[key]


def reference_net(cfg: dict, seed: int, device):
    """The plain float32 reference U-Net with the same weights."""
    from reference.cqt import CQT
    from reference.unet import UNet
    n, e = cfg["network"], cfg["exp"]
    cqt = CQT(int(n["cqt"]["num_octs"]), int(n["cqt"]["bins_per_oct"]), float(e["sample_rate"]),
              int(e["audio_len"]), ("kaiser", float(n["cqt"]["beta"])))
    with torch.device(device):
        net = UNet(n, cqt)
    net.load_state_dict(make_weights(cfg, seed, device))
    return net, cqt


class ScoreCount:
    """Denoiser calls the device ran: forwards of the sampler's model made
    outside a CUDA graph capture, plus those that replays of the sampler's
    programs ran (each program counts what its captures recorded). The idea
    of ``bench_torch.ScoreCount``, read from outside the program."""

    def __init__(self, sampler):
        self.sampler, self.eager = sampler, 0

        def hook(module, args):
            if not (torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()):
                self.eager += 1

        self.handle = sampler.model.register_forward_pre_hook(hook)

    def total(self) -> int:
        return self.eager + sum(p.replayed_scores for p in self.sampler._programs.values())

    def close(self) -> None:
        self.handle.remove()


def sampler_counters(sampler, scores: ScoreCount) -> Dict[str, float]:
    """Denoiser calls, fused-kernel launches, trajectories and rows run."""
    from aid_tpu_torch.ops import fused_adaln
    runs = rows = 0
    for p in sampler._programs.values():
        n = p.replays // p.cfg.T
        runs, rows = runs + n, rows + n * p.shape[0]
    return {"scores": scores.total(), "launches": fused_adaln.launch_count(),
            "trajectories": runs, "rows": rows}
