"""Plain reference of one EDM training step of the U-Net with clipped Adam,
the learning-rate ramp, the relative skip guardrail and the EMA.

A frozen copy of the semantics of the port's ``training/trainer.py``
(``_inputs``, ``_backward``, ``_update``, and the dp step's gradient
average over the ranks) for one micro-batch: each rank's rows draw the
polarity sign, sigma (the rho_train ramp) and the noise, in that order,
from a generator seeded as that rank's trainer seeds its own (the
trainer's seed + 1000003 x the rank); the loss is the per-sample mean
squared error of the preconditioned net, averaged over the rows of every
rank (the ranks' average of their rows' averages, which the dp step's
all-reduce forms); the gradient's global norm is clipped to
``max_grad_norm`` (g max / |g| when |g| >= max); Adam's first update has
learning rate 0 (the ramp reads the count before it grows); a step whose
norm is not finite or exceeds ``skip_grad_factor`` times the running norm
keeps the state. Rows go through the net one at a time, so the float32
reference fits beside nothing else. Imports nothing of the port.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


RANK_SEED_STRIDE = 1000003      # a rank's generator: the trainer's seed + this x the rank


class Reference:
    def __init__(self, net, d: dict, tr: dict, batch: int, seed: int, device, ranks: int = 1):
        """``net``: the reference net with the benchmark's weights; ``d``:
        the training EDM parameters; ``tr``: the trainer's settings (the
        configuration file's training role); ``batch``: the global batch,
        ``batch / ranks`` rows a rank; ``seed``: the trainer's."""
        if batch % ranks:
            raise ValueError(f"a global batch of {batch} does not split over {ranks} ranks")
        self.net, self.d, self.tr, self.B = net, d, tr, batch
        self.device = device
        self.params = [p for p in net.parameters()]
        self.trainable = [p.requires_grad for p in self.params]
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.ema = [p.detach().clone() for p in self.params]
        self.count = 0
        self.gnorm_ema = 0.0
        self.it = 0
        self.gens = [torch.Generator(device=device).manual_seed(int(seed) + RANK_SEED_STRIDE * r)
                     for r in range(ranks)]

    def _draws(self, L: int):
        """Each rank's sign, sigma and noise from its own generator, in rank order."""
        d, rows = self.d, self.B // len(self.gens)
        signs, sigmas, noises = [], [], []
        for g in self.gens:
            if self.tr["rev_polarity"]:
                signs.append(1.0 - 2.0 * (torch.rand((rows, 1), generator=g, device=self.device)
                                          < 0.5).float())
            a = torch.rand((rows,), generator=g, device=self.device)
            lo, hi = d["sigma_min"] ** (1 / d["rho_train"]), d["sigma_max"] ** (1 / d["rho_train"])
            sigma = (hi + a * (lo - hi)) ** d["rho_train"]
            sigmas.append(sigma)
            noises.append(torch.randn((rows, L), generator=g, device=self.device) * sigma.reshape(-1, 1))
        return (torch.cat(signs) if signs else None), torch.cat(sigmas), torch.cat(noises)

    def loss_and_grads(self, audio: torch.Tensor):
        """(loss, gradients) of one batch [B, L], rows one at a time."""
        sign, sigma, noise = self._draws(audio.shape[-1])
        x = audio * sign if sign is not None else audio
        sd = self.d["sigma_data"]
        grads = [torch.zeros_like(p) for p in self.params]
        loss = 0.0
        for r in range(self.B):
            s = sigma[r:r + 1].reshape(1, 1)
            xn = x[r:r + 1] + noise[r:r + 1]
            cskip = sd ** 2 / (s ** 2 + sd ** 2)
            cout = s * sd * (sd ** 2 + s ** 2) ** -0.5
            cin = (sd ** 2 + s ** 2) ** -0.5
            target = (x[r:r + 1] - cskip * xn) / cout
            err = self.net(cin * xn, 0.25 * torch.log(s)) - target
            ps = err.square().mean() / self.B
            gs = torch.autograd.grad(ps, [p for p, t in zip(self.params, self.trainable) if t])
            it = iter(gs)
            for i, t in enumerate(self.trainable):
                if t:
                    grads[i] += next(it)
            loss += float(ps.detach())
        return loss, grads

    def step(self, audio: torch.Tensor) -> Dict[str, object]:
        """One step; returns its loss and the clipped gradient's leaf norms."""
        loss, grads = self.loss_and_grads(audio)
        with torch.no_grad():
            return self._update(loss, grads)

    def _update(self, loss: float, grads: List[torch.Tensor]) -> Dict[str, object]:
        tr = self.tr
        gnorm = float(torch.linalg.vector_norm(torch.stack([g.norm() for g in grads])))
        if tr["use_grad_clip"] and gnorm >= tr["max_grad_norm"]:
            grads = [g * (tr["max_grad_norm"] / gnorm) for g in grads]
        b1, b2, eps = tr["beta1"], tr["beta2"], tr["eps"]
        t = self.count + 1
        lr = tr["lr"] * min(self.count / max(int(tr["lr_rampup_it"]), 1), 1.0)
        new = []
        for p, m, v, g in zip(self.params, self.mu, self.nu, grads):
            m2 = m * b1 + (1 - b1) * g
            v2 = v * b2 + (1 - b2) * g * g
            upd = (m2 / (1 - b1 ** t)) / ((v2 / (1 - b2 ** t)).sqrt() + eps)
            new.append((p - lr * upd, m2, v2))
        ok = np.isfinite(gnorm)
        warm = self.gnorm_ema > 0.0
        if tr["skip_grad_factor"] > 0:
            ok = ok and (not warm or gnorm < tr["skip_grad_factor"] * self.gnorm_ema)
        if tr["skip_grad_norm"] > 0:
            ok = ok and gnorm < tr["skip_grad_norm"]
        if ok:
            for p, m, v, (p2, m2, v2) in zip(self.params, self.mu, self.nu, new):
                p.copy_(p2)
                m.copy_(m2)
                v.copy_(v2)
            self.count += 1
        g_obs = gnorm if np.isfinite(gnorm) else self.gnorm_ema
        if tr["skip_grad_factor"] > 0 and warm:
            g_obs = min(g_obs, tr["skip_grad_factor"] * self.gnorm_ema)
        self.gnorm_ema = 0.98 * self.gnorm_ema + 0.02 * g_obs if warm else g_obs
        tb = (self.it + 1.0) * self.B
        rate = min(tr["ema_rate"], (1.0 + tb) / (10.0 + tb)) if tr["ema_rampup"] else tr["ema_rate"]
        for e, p in zip(self.ema, self.params):
            e.add_((p - e) * (1.0 - rate))
        self.it += 1
        return {"loss": loss, "grad_norms": [float(g.norm()) for g in grads]}
