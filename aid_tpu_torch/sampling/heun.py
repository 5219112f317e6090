"""Stochastic 2nd-order Heun posterior sampler in PyTorch.

Port of ``aid_tpu/sampling/heun.py``: the same score branches
(unconditional, reconstruction-guided, replacement-only), per-sample
guidance normalisation, both guidance-epsilon placements, churn, the Heun
correction, and the final Euler step outside the loop. As in the JAX
package a trajectory is ``T - 1`` steps of one body (``heun_body``: churn,
score, Euler step, Heun correction) and one last step (``heun_last``:
churn, score, Euler step), each reading its step values from 0-dim
tensors: ``heun_sample`` loops over them eagerly, and
``sampling/program.py`` captures the same two functions as CUDA graphs.
Guidance is ``torch.autograd.grad`` of the summed per-sample residual norms
through the denoiser.

Noise is injected: ``prior [B, L]`` and ``churn [T, B, L]`` standard-normal
draws (the JAX package draws them from threefry keys, which torch cannot
reproduce); when not given they are drawn from a ``torch.Generator``.

Hooks (all optional): degradation(x) -> observation-space prediction;
proj(x) -> data-consistency projection; hpf(x) -> band-limit filter.

With ``SamplerConfig.record`` (the tester's ``rid`` mode) a score function
returns ``(score, Record)`` and ``heun_sample`` returns ``(x, Record)``,
the Record's fields stacked over the steps ``[T, B, L]``: each step records
its first score call, with ``xt2`` the step's updated x. A built program
writes each step's Record into ``[T, B, L]`` buffers instead
(``write_record``), at a step index it holds on the device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple

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
    record: bool = False             # rid-style trajectory recording


class Record(NamedTuple):
    """Per-step intermediates: the churned x, the denoised estimate, the
    scaled guidance gradient, the guided estimate, the projected estimate
    and the step's updated x."""
    xt: torch.Tensor
    denoised: torch.Tensor
    grads: torch.Tensor
    grad_update: torch.Tensor
    pocs: torch.Tensor
    xt2: torch.Tensor


def write_record(records: Record, i: torch.Tensor, rec: Record) -> None:
    """Write one step's ``rec`` into slot ``i`` (a 0-dim index tensor) of
    the ``[T, ...]`` buffers ``records``, on the device."""
    i = i.reshape(1)
    for buf, field in zip(records, rec):
        buf.index_copy_(0, i, field.unsqueeze(0))


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
    """score(x, t) -> score (and its Record when ``cfg.record``), with the
    three branches of the JAX package."""
    use_hpf = cfg.filter_out_cqt_DC_Nyq and hpf is not None

    def out(score, *fields):
        if not cfg.record:
            return score
        zero = torch.zeros_like(score)
        return score, Record(*(zero if f is None else f for f in fields), zero)

    def x_hat_of(x, t):
        xh = denoise(x, t)
        return hpf(xh) if use_hpf else xh

    if y is None:
        def score_uncond(x, t):
            with torch.no_grad():
                xh = x_hat_of(x, t)
                return out((xh - x) / t ** 2, x, xh, None, xh, xh)
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
                return out((xh2 - x) / t ** 2, x, xh, s * g, xh1, xh2)
        return score_guided

    def score_replace(x, t):
        # no hpf in this branch, as the reference's replacement sampler
        with torch.no_grad():
            xh = denoise(x, t)
            xh2 = proj(xh) if proj is not None else xh
            return out((xh2 - x) / t ** 2, x, xh, None, xh, xh2)
    return score_replace


def draw_noise(shape: Tuple[int, ...], T: int, generator: Optional[torch.Generator] = None,
               device=None, prior: Optional[torch.Tensor] = None,
               churn: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The standard-normal prior [shape] and churn [T, shape], each the
    injected tensor when given, else drawn from ``generator`` (the prior
    first); shapes checked."""
    shape = tuple(shape)
    if prior is None:
        prior = torch.randn(shape, generator=generator, device=device)
    if churn is None:
        churn = torch.randn((T,) + shape, generator=generator, device=device)
    if tuple(prior.shape) != shape or tuple(churn.shape) != (T,) + shape:
        raise ValueError(f"noise shapes prior {tuple(prior.shape)}, churn "
                         f"{tuple(churn.shape)} do not fit {shape} x T={T}")
    return prior, churn


def _score(cfg: SamplerConfig, score_fn: Callable, x, t):
    out = score_fn(x, t)
    return out if cfg.record else (out, None)


def _churn(p: edm.EDMParams, x, t_i, g_i, z):
    """t_hat = t + gamma t, with sqrt(t_hat^2 - t^2) extra noise."""
    t_hat = t_i + g_i * t_i
    extra = torch.clamp_min(t_hat ** 2 - t_i ** 2, 0.0).sqrt()
    return t_hat, x + extra * (z * p.Snoise)


def heun_body(p: edm.EDMParams, cfg: SamplerConfig, score_fn: Callable, x: torch.Tensor,
              t_i: torch.Tensor, t_next: torch.Tensor, g_i: torch.Tensor,
              z: torch.Tensor):
    """One step before the last: churn with the standard-normal row ``z``,
    the Euler step d = -t_hat score and, at order 2, the Heun correction at
    ``t_next``. The step values are 0-dim tensors, so the step has no branch
    on them. Returns (x, the step's Record or None)."""
    t_hat, x = _churn(p, x, t_i, g_i, z)
    score, rec = _score(cfg, score_fn, x, t_hat)
    d = -t_hat * score
    h = t_next - t_hat
    if cfg.order == 2:
        x_prime = x + h * d
        score2, _ = _score(cfg, score_fn, x_prime, t_next)
        d_prime = -t_next * score2
        return x + h * 0.5 * (d + d_prime), rec
    return x + h * d, rec


def heun_last(p: edm.EDMParams, cfg: SamplerConfig, score_fn: Callable, x: torch.Tensor,
              t_i: torch.Tensor, t_next: torch.Tensor, g_i: torch.Tensor,
              z: torch.Tensor):
    """The last step (t_next = 0): churn and an Euler step."""
    t_hat, x = _churn(p, x, t_i, g_i, z)
    score, rec = _score(cfg, score_fn, x, t_hat)
    return x + (t_next - t_hat) * (-t_hat * score), rec


def heun_sample(shape: Tuple[int, ...], p: edm.EDMParams, cfg: SamplerConfig,
                score_fn: Callable, proj_end: Optional[Callable] = None,
                prior: Optional[torch.Tensor] = None,
                churn: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                device=None):
    """Run the sampler eagerly: prior at t[0]; T - 1 ``heun_body`` steps,
    then ``heun_last``; a final projection when data consistency is "end".
    Returns x, or (x, Record) when ``cfg.record``."""
    if device is None and prior is not None:
        device = prior.device
    else:
        device = resolve_device(device)
    t = edm.create_schedule(p, cfg.T, device=device)
    gamma = edm.get_gamma(p, t[:-1])
    prior, churn = draw_noise(shape, cfg.T, generator, device, prior, churn)
    x = prior * t[0]
    records = []
    for i in range(cfg.T):
        step = heun_last if i == cfg.T - 1 else heun_body
        x, rec = step(p, cfg, score_fn, x, t[i], t[i + 1], gamma[i], churn[i])
        if cfg.record:
            records.append(rec._replace(xt2=x))
    if cfg.data_consistency_end and proj_end is not None:
        x = proj_end(x)
    if cfg.record:
        return x, Record(*(torch.stack(f) for f in zip(*records)))
    return x
