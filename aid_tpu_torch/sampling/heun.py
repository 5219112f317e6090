"""Stochastic 2nd-order Heun posterior sampler in PyTorch.

Port of ``aid_tpu/sampling/heun.py``: the same score branches
(unconditional, reconstruction-guided, replacement-only), per-sample
guidance normalisation, both guidance-epsilon placements, churn, the Heun
correction, and the final Euler step outside the loop. The loop is a
Python loop. Guidance is ``torch.autograd.grad`` of the summed per-sample
residual norms through the denoiser.

Noise is injected: ``prior [B, L]`` and ``churn [T, B, L]`` standard-normal
draws (the JAX package draws them from threefry keys, which torch cannot
reproduce); when not given they are drawn from a ``torch.Generator``.

Hooks (all optional): degradation(x) -> observation-space prediction;
proj(x) -> data-consistency projection; hpf(x) -> band-limit filter.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from aid_tpu_torch.diffusion import edm
from aid_tpu_torch.setup import resolve_device


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Static sampling options (configs/tester/inpainting_tester.yaml)."""
    T: int = 35
    order: int = 2
    xi: float = 0.25                 # reconstruction-guidance strength
    norm: Any = 2                    # 1 | 2 | "smoothl1"
    smoothl1_beta: float = 1.0
    data_consistency: bool = True    # project every step ("always")
    data_consistency_end: bool = False
    filter_out_cqt_DC_Nyq: bool = True
    # "inpainting": s = t xi / (|g|/sqrt(L) + eps) on x_hat;
    # "generic":    s = t^2 xi / (|g|/sqrt(L) t + eps) (the x_hat form of the
    #               reference's generic sampler)
    guidance_eps: str = "inpainting"


def _residual_norm(cfg: SamplerConfig, r: torch.Tensor) -> torch.Tensor:
    """Observation-error norm, per sample."""
    flat = r.reshape(r.shape[0], -1)
    if cfg.norm == "smoothl1":
        b = cfg.smoothl1_beta
        a = flat.abs()
        return torch.where(a < b, 0.5 * a ** 2 / b, a - 0.5 * b).sum(-1)
    if cfg.norm == 1:
        return flat.abs().sum(-1)
    return flat.square().sum(-1).sqrt()


def make_score_fn(p: edm.EDMParams, cfg: SamplerConfig,
                  denoise: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                  y: Optional[torch.Tensor] = None,
                  degradation: Optional[Callable] = None,
                  proj: Optional[Callable] = None,
                  hpf: Optional[Callable] = None) -> Callable:
    """score(x, t) -> score, with the three branches of the JAX package."""
    use_hpf = cfg.filter_out_cqt_DC_Nyq and hpf is not None

    def x_hat_of(x, t):
        xh = denoise(x, t)
        return hpf(xh) if use_hpf else xh

    if y is None:
        def score_uncond(x, t):
            with torch.no_grad():
                return (x_hat_of(x, t) - x) / t ** 2
        return score_uncond

    if cfg.xi > 0:
        if degradation is None:
            raise ValueError("guided sampling needs a degradation operator")

        def score_guided(x, t):
            L = x[0].numel()
            with torch.enable_grad():
                xg = x.detach().requires_grad_(True)
                xh = x_hat_of(xg, t)
                nrm = _residual_norm(cfg, y - degradation(xh))
                (g,) = torch.autograd.grad(nrm.sum(), xg)
            xh = xh.detach()
            with torch.no_grad():
                gnorm = g.reshape(g.shape[0], -1).square().sum(-1).sqrt()
                normguide = gnorm / (L ** 0.5)
                if cfg.guidance_eps == "generic":
                    s = t ** 2 * cfg.xi / (normguide * t + 1e-6)
                else:
                    s = t * cfg.xi / (normguide + 1e-6)
                s = s.reshape(-1, *([1] * (x.dim() - 1)))
                xh1 = xh - s * g
                xh2 = proj(xh1) if (cfg.data_consistency and proj is not None) else xh1
                return (xh2 - x) / t ** 2
        return score_guided

    def score_replace(x, t):
        # no hpf in this branch, as the reference's replacement sampler
        with torch.no_grad():
            xh = denoise(x, t)
            xh2 = proj(xh) if proj is not None else xh
            return (xh2 - x) / t ** 2
    return score_replace


def heun_sample(shape: Tuple[int, ...], p: edm.EDMParams, cfg: SamplerConfig,
                score_fn: Callable, proj_end: Optional[Callable] = None,
                prior: Optional[torch.Tensor] = None,
                churn: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                device=None) -> torch.Tensor:
    """Run the sampler: prior at t[0]; per step churn t_hat = t + gamma t with
    sqrt(t_hat^2 - t^2) extra noise, the Euler step d = -t_hat score and (at
    order 2, except on the last step) the Heun correction at t_next; a final
    projection when data consistency is "end"."""
    if device is None and prior is not None:
        device = prior.device
    else:
        device = resolve_device(device)
    t = edm.create_schedule(p, cfg.T, device=device)
    gamma = edm.get_gamma(p, t[:-1])
    if prior is None:
        prior = torch.randn(shape, generator=generator, device=device)
    if churn is None:
        churn = torch.randn((cfg.T,) + tuple(shape), generator=generator, device=device)
    if tuple(prior.shape) != tuple(shape) or tuple(churn.shape) != (cfg.T,) + tuple(shape):
        raise ValueError(f"noise shapes prior {tuple(prior.shape)}, churn "
                         f"{tuple(churn.shape)} do not fit {tuple(shape)} x T={cfg.T}")
    x = prior * t[0]
    for i in range(cfg.T):
        last = i == cfg.T - 1
        t_i, t_next, g_i = t[i], t[i + 1], gamma[i]
        t_hat = t_i + g_i * t_i
        extra = torch.clamp_min(t_hat ** 2 - t_i ** 2, 0.0).sqrt()
        x = x + extra * (churn[i] * p.Snoise)
        d = -t_hat * score_fn(x, t_hat)
        h = t_next - t_hat
        if cfg.order == 2 and not last:
            x_prime = x + h * d
            d_prime = -t_next * score_fn(x_prime, t_next)
            x = x + h * 0.5 * (d + d_prime)
        else:
            x = x + h * d
    if cfg.data_consistency_end and proj_end is not None:
        x = proj_end(x)
    return x
