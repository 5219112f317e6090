"""Training steps through ``Trainer.train_step``, which replays the captured
step program: a unit is one step on a host batch from a pool made in
set-up (the loader is bypassed). Set-up takes the trainer through its
first ``FIRST`` steps (the first builds the program) and keeps what the
reference is compared on: each step's loss, the first clipped gradient's
norm per parameter (from Adam's first moment after one step), and each
parameter's change and its EMA's change after ``FIRST`` steps. The window
goes on from there with the same trainer.

Traffic parameters: ``pool`` (distinct host batches, served in turn).
"""
from __future__ import annotations

import tempfile
from typing import Dict, List

import numpy as np
import torch

import inputs
import port
from reference import settings
from reference.training import Reference

FAMILY = "train"
TRACE_UNITS = 5
FIRST = 3


@torch.no_grad()
def _norms(tensors: List[torch.Tensor]) -> List[float]:
    return [float(v) for v in torch.stack(torch._foreach_norm(tensors)).cpu()]


@torch.no_grad()
def _change(now: List[torch.Tensor], then: List[torch.Tensor]) -> List[float]:
    return _norms(torch._foreach_sub(now, then))


def median_gap(prog: Dict[str, float], ref: Dict[str, float], names) -> float:
    """The median over ``names`` of |program's norm - reference's| / reference's."""
    return float(np.median([abs(prog[n] - ref[n]) / ref[n] for n in names]))


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float], names) -> float:
    """The worst |program's norm - reference's| over ``names``, each against
    the larger of the reference's norm and the median reference norm."""
    med = float(np.median([ref[n] for n in ref]))
    return max(abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in names)


class Bench:
    def __init__(self, cfg: dict, mix: dict, seed: int, device, control: bool = False):
        from aid_tpu_torch import setup as tsetup
        self.cfg, self.seed, self.device = cfg, seed, device
        args = port.compose(cfg, "training", control)
        self.tmp = tempfile.TemporaryDirectory()
        args["model_dir"] = self.tmp.name
        args.logging["print_model_summary"] = False
        args.logging["save_model"] = False
        self.trainer_seed = inputs.substream(seed, 7)
        args.exp["seed"] = self.trainer_seed
        self.B, self.L = int(args.exp.batch), int(args.exp.audio_len)
        self.fs = np.full((self.B,), int(args.exp.sample_rate), np.int64)
        net = port.network(args, cfg, inputs.substream(seed, 1), device, trainable=True)
        self.trainer = t = tsetup.setup_trainer(args, network=net,
                                                diff_params=tsetup.setup_diff_parameters(args))
        t.init_state()
        self.batches = inputs.train_batches(int(mix["pool"]), self.B, self.L, inputs.substream(seed, 8))
        p0 = [p.detach().clone() for p in t.params]
        losses = []
        for k in range(FIRST):
            losses.append(t.train_step(self.batches[k], self.fs)["loss"])
            if k == 0:
                grad = [n / (1.0 - t.b1) for n in _norms(t.mu)]
        self.first = {"loss": [float(v) for v in losses],
                      "grad": dict(zip(t.names, grad)),
                      "change": dict(zip(t.names, _change(t.params, p0))),
                      "ema": dict(zip(t.names, _change(t.ema, p0)))}
        del p0

    def unit(self, i: int) -> None:
        self.trainer.train_step(self.batches[(FIRST + i) % len(self.batches)], self.fs)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def counters(self) -> Dict[str, float]:
        from aid_tpu_torch.ops import fused_adaln
        return {"launches": fused_adaln.launch_count(), "steps": self.trainer.it}

    def built(self) -> Dict[str, float]:
        return {"capture_s": sum(p.capture_s for p in self.trainer._step_programs.values()),
                "rows": self.B, "itemsize": torch.finfo(self.trainer.net.dtype).bits // 8}

    def end_to_end(self, count: int, wall: float) -> dict:
        return {"train_step_ms": {"value": wall / count * 1e3, "unit": "ms"}}

    def check(self, limits: dict) -> dict:
        """The first ``FIRST`` steps against the float32 reference's."""
        del self.trainer
        port.free(self.device)
        self.tmp.cleanup()
        names, out, change, ema = port.cached(self.reference_cache, self.seed, self._reference)
        grad = dict(zip(names, out[0]["grad_norms"]))
        med = float(np.median(list(grad.values())))
        moving = [n for n in names if grad[n] >= 1e-3 * med]
        loss = max(abs(a - r["loss"]) / abs(r["loss"]) for a, r in zip(self.first["loss"], out))
        nums = {"loss_rel_err": loss,
                "grad_leaf_gap": leaf_gap(self.first["grad"], grad, names),
                "change_median_gap": median_gap(self.first["change"], change, moving),
                "ema_leaf_gap": leaf_gap(self.first["ema"], ema, moving)}
        return {k: {"value": v, "limit": limits.get(k, 0.0)} for k, v in nums.items()}

    def _reference(self):
        """(names, each step's loss and gradient norms, each parameter's
        change, its EMA's change) of the float32 reference's first ``FIRST``
        steps (the EMA starts at the parameters)."""
        d, tr = settings.training(self.cfg)
        net, _ = port.reference_net(self.cfg, inputs.substream(self.seed, 1), self.device)
        named = list(net.named_parameters())
        names = [n for n, _ in named]
        p0 = [p.detach().clone() for _, p in named]
        ref = Reference(net, d, tr, self.B, self.trainer_seed, self.device)
        with port.Exact32():
            out = [ref.step(torch.from_numpy(self.batches[k]).to(self.device)) for k in range(FIRST)]
        return (names, out, dict(zip(names, _change([p for _, p in named], p0))),
                dict(zip(names, _change(ref.ema, p0))))
