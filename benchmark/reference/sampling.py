"""Plain reference of EDM-preconditioned stochastic Heun sampling with
reconstruction guidance, and of the inpainting service's planning.

Frozen copies of the mathematics of the port's ``diffusion/edm.py``
(schedule, churn, preconditioning), ``sampling/heun.py`` (the guided score,
the Heun body and last step), ``sampling/degradations.py`` (the time mask,
the Hann-smoothed projection mask) and ``serving.py`` (one window centred
on each gap, rows in gap order, one noise seed per round drawn from the
request seed). Each round's noise is drawn from PyTorch's generator seeded
as the service seeds it, the prior first, then every churn row. Float32,
no graphs, no kernels; imports nothing of the port.
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch


# ---------------------------------------------------------------- EDM


def schedule(d: dict, T: int, device) -> torch.Tensor:
    i = torch.arange(T + 1, dtype=torch.float32, device=device)
    a, b = d["sigma_max"] ** (1 / d["rho"]), d["sigma_min"] ** (1 / d["rho"])
    t = (a + i / (T - 1) * (b - a)) ** d["rho"]
    t[-1] = 0.0
    return t


def gammas(d: dict, t: torch.Tensor) -> torch.Tensor:
    val = min(d["Schurn"] / t.shape[0], math.sqrt(2.0) - 1.0)
    inside = (t > d["Stmin"]) & (t < d["Stmax"])
    return torch.where(inside, torch.full_like(t, val), torch.zeros_like(t))


def denoise(d: dict, net, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """D(x, t) = cskip x + cout net(cin x, log(t) / 4), one sigma for all rows."""
    s = t.reshape(1, 1).expand(x.shape[0], 1).float()
    sd = d["sigma_data"]
    cskip = sd ** 2 / (s ** 2 + sd ** 2)
    cout = s * sd * (sd ** 2 + s ** 2) ** -0.5
    cin = (sd ** 2 + s ** 2) ** -0.5
    return cskip * x + cout * net(cin * x, 0.25 * torch.log(s))


# ------------------------------------------------------------ sampling


def score_fn(d: dict, s: dict, net, hpf: Optional[Callable], y, mask, smooth):
    """The score of one step, guided by ||y - m x_hat|| with the
    data-consistency projection smooth y + (1 - smooth) x; the estimate
    goes through the net's output filter ``hpf`` where it has one and the
    sampler's ``filter_out_cqt_DC_Nyq`` is on."""
    def x_hat(x, t):
        xh = denoise(d, net, x, t)
        return hpf(xh) if hpf is not None and s["filter_out_cqt_DC_Nyq"] else xh

    def guided(x, t):
        L = x[0].numel()
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            xh = x_hat(xg, t)
            r = (y - mask * xh).reshape(x.shape[0], -1)
            (g,) = torch.autograd.grad(r.square().sum(-1).sqrt().sum(), xg)
        with torch.no_grad():
            xh = xh.detach()
            normguide = g.reshape(g.shape[0], -1).square().sum(-1).sqrt() / L ** 0.5
            step = (t * s["xi"] / (normguide + 1e-6)).reshape(-1, 1)
            xh2 = smooth * y + (1.0 - smooth) * (xh - step * g)
            return (xh2 - x) / t ** 2
    return guided


def heun(d: dict, s: dict, score, prior: torch.Tensor, churn: torch.Tensor) -> torch.Tensor:
    """Stochastic Heun from ``prior`` [B, L] with ``churn`` [T, B, L]: T - 1
    second-order steps, then one Euler step to t = 0."""
    T = s["T"]
    t = schedule(d, T, prior.device)
    gam = gammas(d, t[:-1])
    x = prior * t[0]
    for i in range(T):
        t_hat = t[i] + gam[i] * t[i]
        x = x + torch.clamp_min(t_hat ** 2 - t[i] ** 2, 0.0).sqrt() * (churn[i] * d["Snoise"])
        dx = -t_hat * score(x, t_hat)
        h = t[i + 1] - t_hat
        if i < T - 1 and s["order"] == 2:
            d2 = -t[i + 1] * score(x + h * dx, t[i + 1])
            x = x + h * 0.5 * (dx + d2)
        else:
            x = x + h * dx
    return x


def draw(shape: Tuple[int, ...], T: int, seed: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The prior [shape] and churn [T, shape] from a generator seeded with
    ``seed`` on ``device``, the prior first."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    prior = torch.randn(shape, generator=gen, device=device)
    return prior, torch.randn((T,) + tuple(shape), generator=gen, device=device)


# ------------------------------------------------------------ inpainting


def smooth_row(m: np.ndarray, hann: int) -> np.ndarray:
    """Hann cross-fades on the observed side of each gap edge."""
    n = len(m)
    w = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(2 * hann) / (2 * hann))
    out = m.astype(np.float64).copy()
    for i in np.flatnonzero(np.diff(m) != 0) + 1:
        if m[i] == 0:
            lo = max(0, i - hann)
            out[lo:i] = w[hann:][hann - (i - lo):]
        else:
            hi = min(n, i + hann)
            out[i:hi] = w[:hi - i]
    return out.astype(np.float32)


def gaps_of(mask: np.ndarray) -> List[Tuple[int, int]]:
    m = mask > 0.5
    edges = np.flatnonzero(np.diff(np.concatenate([[True], m, [True]])))
    return [(int(edges[i]), int(edges[i + 1])) for i in range(0, len(edges), 2)]


def plan(mask: np.ndarray, L: int, rows: int) -> List[List[Tuple[int, int, int]]]:
    """Rounds of (w0, a, b): a window of L samples centred on each gap
    (clipped to the signal), its own gap at [a, b), ``rows`` windows a
    round in gap order. Gaps longer than a window's chain limit are not
    planned here: the benchmark's traffic has none."""
    T = len(mask)
    jobs = []
    for g0, g1 in gaps_of(mask):
        if g1 - g0 > int(0.6 * L):
            raise ValueError("the reference plans single-window gaps only")
        w0 = int(np.clip((g0 + g1) // 2 - L // 2, 0, T - L))
        jobs.append((w0, max(g0 - w0, 0), min(g1 - w0, L)))
    return [jobs[i:i + rows] for i in range(0, len(jobs), rows)]


def inpaint(d: dict, s: dict, net, hpf: Optional[Callable], audio: np.ndarray, mask: np.ndarray,
            seed: int, rows: int, device) -> np.ndarray:
    """The restored request: every round's windows sampled together with the
    round's noise, each written back inside its own gap; observed samples
    are the input's. ``hpf``: the net's output filter, or None."""
    L = int(s["audio_len"])
    audio = np.asarray(audio, np.float32)
    out, live = audio.copy(), np.asarray(mask, np.float32).copy()
    seeds = np.random.default_rng(seed)
    for rnd in plan(live, L, rows):
        xb = np.stack([out[w0:w0 + L] for w0, _, _ in rnd])
        mb = np.stack([live[w0:w0 + L] for w0, _, _ in rnd])
        for r, (_, a, b) in enumerate(rnd):
            mb[r, a:b] = 0.0
        sm = np.stack([smooth_row(m, int(s["hann_size"])) for m in mb])
        y = torch.from_numpy(xb * mb).to(device)
        m = torch.from_numpy(mb).to(device)
        sm = torch.from_numpy(sm).to(device)
        prior, churn = draw(tuple(y.shape), s["T"], int(seeds.integers(2 ** 62)), device)
        rec = heun(d, s, score_fn(d, s, net, hpf, y, m, sm), prior, churn)
        rec = rec.float().cpu().numpy()
        for r, (w0, a, b) in enumerate(rnd):
            out[w0 + a:w0 + b] = rec[r, a:b]
            live[w0 + a:w0 + b] = 1.0
    return np.where(np.asarray(mask) > 0.5, audio, out).astype(np.float32)
