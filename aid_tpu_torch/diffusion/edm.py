"""EDM diffusion parameterisation (Karras et al. 2022) in PyTorch.

Port of ``aid_tpu/diffusion/edm.py``: schedule, churn gamma, the
c_skip / c_out / c_in / c_noise preconditioning, the denoiser wrapper, the
training-sigma draws and the training loss. Draws take an explicit
``torch.Generator``; the loss also takes injected ``sigma`` and ``noise``
(torch cannot reproduce JAX's threefry streams, so parity tests feed both
packages the same draws).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class EDMParams:
    """Static diffusion hyper-parameters (configs/diff_params/edm.yaml)."""
    sigma_data: float = 0.063
    sigma_min: float = 1e-5
    sigma_max: float = 10.0
    rho: float = 13.0
    rho_train: float = 10.0
    P_mean: float = -1.2
    P_std: float = 1.2
    Schurn: float = 5.0
    Snoise: float = 1.0
    Stmin: float = 0.0
    Stmax: float = 50.0

    @classmethod
    def from_args(cls, dp) -> "EDMParams":
        """Build from a diff_params config node (``ro`` spelling as the
        reference's configs)."""
        return cls(
            sigma_data=float(dp.sigma_data), sigma_min=float(dp.sigma_min),
            sigma_max=float(dp.sigma_max), rho=float(dp.ro),
            rho_train=float(dp.get("ro_train", dp.ro)),
            P_mean=float(dp.get("P_mean", -1.2)), P_std=float(dp.get("P_std", 1.2)),
            Schurn=float(dp.Schurn), Snoise=float(dp.Snoise),
            Stmin=float(dp.Stmin), Stmax=float(dp.Stmax))


def create_schedule(p: EDMParams, nb_steps: int, device=None) -> torch.Tensor:
    """Karras rho-schedule, f32, length nb_steps+1, sigma_max -> sigma_min,
    with the last entry exactly zero."""
    i = torch.arange(nb_steps + 1, dtype=torch.float32, device=device)
    a, b = p.sigma_max ** (1 / p.rho), p.sigma_min ** (1 / p.rho)
    t = (a + i / (nb_steps - 1) * (b - a)) ** p.rho
    t[-1] = 0.0
    return t


def get_gamma(p: EDMParams, t: torch.Tensor) -> torch.Tensor:
    """Per-step churn: min(Schurn/N, sqrt(2)-1) where Stmin < t < Stmax."""
    N = t.shape[0]
    val = min(p.Schurn / N, math.sqrt(2.0) - 1.0)
    inside = (t > p.Stmin) & (t < p.Stmax)
    return torch.where(inside, torch.full_like(t, val), torch.zeros_like(t))


def sample_ptrain_safe(p: EDMParams, n: int, gen: Optional[torch.Generator] = None,
                       device=None) -> torch.Tensor:
    """Training sigmas from the rho_train-shaped schedule distribution
    (not log-normal): a uniform draw mapped through the Karras ramp."""
    a = torch.rand((n,), generator=gen, device=device)
    lo, hi = p.sigma_min ** (1 / p.rho_train), p.sigma_max ** (1 / p.rho_train)
    return (hi + a * (lo - hi)) ** p.rho_train


def sample_ptrain_lognormal(p: EDMParams, n: int, gen: Optional[torch.Generator] = None,
                            device=None) -> torch.Tensor:
    """The Karras log-normal alternative (unused by default)."""
    ln = torch.randn((n,), generator=gen, device=device) * p.P_std + p.P_mean
    return torch.clamp(torch.exp(ln), p.sigma_min, p.sigma_max)


def sample_prior(p: EDMParams, shape, sigma, gen: Optional[torch.Generator] = None,
                 device=None) -> torch.Tensor:
    """sigma-scaled Gaussian noise."""
    return torch.randn(shape, generator=gen, device=device) * sigma


def cskip(p: EDMParams, sigma):
    return p.sigma_data ** 2 / (sigma ** 2 + p.sigma_data ** 2)


def cout(p: EDMParams, sigma):
    return sigma * p.sigma_data * (p.sigma_data ** 2 + sigma ** 2) ** -0.5


def cin(p: EDMParams, sigma):
    return (p.sigma_data ** 2 + sigma ** 2) ** -0.5


def cnoise(p: EDMParams, sigma):
    """(1/4) log sigma, fed to the noise embedding."""
    return 0.25 * torch.log(sigma)


def lambda_w(p: EDMParams, sigma):
    return (sigma * p.sigma_data) ** -2 * (p.sigma_data ** 2 + sigma ** 2)


def denoiser(p: EDMParams, net: Callable, xn: torch.Tensor,
             sigma: torch.Tensor) -> torch.Tensor:
    """D(x, sigma) = cskip x + cout net(cin x, cnoise).
    net: (x [B, T], cnoise [B, 1]) -> [B, T]; sigma [B] or [B, 1]."""
    if sigma.dim() == 1:
        sigma = sigma[:, None]
    return cskip(p, sigma) * xn + cout(p, sigma) * net(cin(p, sigma) * xn,
                                                       cnoise(p, sigma))


def prepare_train_preconditioning(p: EDMParams, x: torch.Tensor, sigma: torch.Tensor,
                                  gen: Optional[torch.Generator] = None,
                                  noise: Optional[torch.Tensor] = None):
    """Network input cin (x + n), regression target (x - cskip (x + n)) / cout
    and cnoise; n = sigma * N(0, 1), drawn from ``gen`` unless ``noise`` (the
    sigma-scaled noise itself) is given."""
    if noise is None:
        noise = sample_prior(p, x.shape, sigma, gen, x.device)
    xn = x + noise
    return cin(p, sigma) * xn, (x - cskip(p, sigma) * xn) / cout(p, sigma), cnoise(p, sigma)


def loss_fn(p: EDMParams, net: Callable, x: torch.Tensor,
            gen: Optional[torch.Generator] = None,
            error_filter: Optional[Callable] = None,
            sigma: Optional[torch.Tensor] = None,
            noise: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-element squared error [B, T] and the sigmas used [B, 1].

    sigma is drawn with ``sample_ptrain_safe`` and then the noise, both from
    ``gen``, unless injected. ``error_filter`` is an optional linear map of
    the raw error applied before squaring (CQT DC correction, A-weighting)."""
    if sigma is None:
        sigma = sample_ptrain_safe(p, x.shape[0], gen, x.device)
    sigma = sigma.reshape(-1, 1)
    net_in, target, cn = prepare_train_preconditioning(p, x, sigma, gen, noise)
    error = net(net_in, cn) - target
    if error_filter is not None:
        error = error_filter(error)
    return error ** 2, sigma


class EDM:
    """Object facade built from the config tree (``diff_params.callable``)."""

    def __init__(self, args):
        self.args = args
        self.params = EDMParams.from_args(args.diff_params)
