"""Guided inpainting requests through ``InpaintingService.inpaint``, closed
loop, one client: a unit is one request.

Traffic parameters: ``request_s`` (seconds of audio a request), ``gaps``
(one entry a gap: its length range ``ms`` and its centre range
``centre_s``), ``audio`` (``inputs.music``'s keywords) and ``pool`` (the
requests made in set-up, served in turn). Set-up builds the service's
program for its rows a round and nothing else.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

import inputs
import port
from reference import sampling as ref_sampling
from reference import settings

FAMILY = "sample"
TRACE_UNITS = 1


class Bench:
    def __init__(self, cfg: dict, mix: dict, seed: int, device, control: bool = False):
        from aid_tpu_torch import setup as tsetup
        from aid_tpu_torch.serving import InpaintingService, find_gaps
        self.cfg, self.seed, self.device = cfg, seed, device
        args = port.compose(cfg, "serving", control)
        self.L, self.fs = int(args.exp.audio_len), int(args.exp.sample_rate)
        self.rows = int(cfg["serving"]["rows_per_round"])
        net = port.network(args, cfg, inputs.substream(seed, 1), device, trainable=False)
        sampler = tsetup.setup_sampler(args, network=net,
                                       diff_params=tsetup.setup_diff_parameters(args))
        self.svc = InpaintingService(args=args, network=net, sampler=sampler, max_batch=self.rows)
        n = int(round(float(mix["request_s"]) * self.fs))
        self.requests = []
        for k in range(int(mix["pool"])):
            mask = inputs.gap_mask(n, self.fs, mix["gaps"], inputs.substream(seed, 3, k))
            self.requests.append((inputs.music(n, self.fs, inputs.substream(seed, 2, k), **mix["audio"]),
                                  mask, inputs.substream(seed, 4, k), len(find_gaps(mask))))
        if any(r[3] != len(mix["gaps"]) for r in self.requests):
            raise ValueError("a request's gaps merged: widen the traffic's centre ranges")
        mask = torch.from_numpy(inputs.center_gap_mask(self.rows, self.L, self.fs)).to(device)
        sampler.compile_inpainting(torch.zeros(self.rows, self.L, device=device), mask)
        self.scores = port.ScoreCount(sampler)
        self.outputs: Dict[int, tuple] = {}

    def unit(self, i: int) -> None:
        k = i % len(self.requests)
        audio, mask, rseed, _ = self.requests[k]
        self.outputs[i] = (k, self.svc.inpaint(audio, mask, self.fs, seed=rseed))

    def counters(self) -> Dict[str, float]:
        return port.sampler_counters(self.svc.sampler, self.scores)

    def built(self) -> Dict[str, float]:
        return {"capture_s": sum(p.capture_s for p in self.svc.sampler._programs.values()),
                "rows": self.rows, "guided": True,
                "itemsize": torch.finfo(self.svc.network.dtype).bits // 8}

    def end_to_end(self, count: int, wall: float) -> dict:
        windows = sum(self.requests[k][3] for k, _ in self.outputs.values())
        return {"rtf": {"value": windows * self.L / self.fs / wall, "unit": "x_realtime"}}

    def check(self, limits: dict) -> dict:
        """Every observed sample of every request back exactly; the gaps of
        one request drawn from the seed against the float32 reference."""
        observed = sum(int(np.count_nonzero((self.requests[k][1] > 0.5) & (out != self.requests[k][0])))
                       for k, out in self.outputs.values())
        pick = sorted(self.outputs)[np.random.default_rng(inputs.substream(self.seed, 5))
                                    .integers(len(self.outputs))]
        k, out = self.outputs[pick]
        audio, mask, rseed, _ = self.requests[k]
        self.scores.close()
        del self.svc, self.scores
        port.free(self.device)

        def reference():
            d, s = settings.sampling(self.cfg)
            net, cqt = port.reference_net(self.cfg, inputs.substream(self.seed, 1), self.device)
            net.requires_grad_(False)
            with port.Exact32():
                return ref_sampling.inpaint(d, s, net, cqt, audio, mask, rseed, self.rows, self.device)

        ref = port.cached(self.reference_cache, (self.seed, k), reference)
        worst = 0.0
        for g0, g1 in ref_sampling.gaps_of(mask):
            r = ref[g0:g1].astype(np.float64)
            worst = max(worst, float(np.linalg.norm(out[g0:g1] - r) / max(np.linalg.norm(r), 1e-12)))
        if not np.all(np.isfinite(out)):
            worst = float("nan")
        return {"observed_changed": {"value": observed, "limit": 0},
                "gap_rel_err": {"value": worst, "limit": limits.get("gap_rel_err", 0.0)}}
