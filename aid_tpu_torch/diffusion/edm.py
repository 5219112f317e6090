"""EDM diffusion parameterisation (Karras et al. 2022) in PyTorch.

Port of ``aid_tpu/diffusion/edm.py``: schedule, churn gamma, the
c_skip / c_out / c_in / c_noise preconditioning and the denoiser wrapper.
The training loss and the training-sigma draws wait for the training slice.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

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


def cskip(p: EDMParams, sigma):
    return p.sigma_data ** 2 / (sigma ** 2 + p.sigma_data ** 2)


def cout(p: EDMParams, sigma):
    return sigma * p.sigma_data * (p.sigma_data ** 2 + sigma ** 2) ** -0.5


def cin(p: EDMParams, sigma):
    return (p.sigma_data ** 2 + sigma ** 2) ** -0.5


def cnoise(p: EDMParams, sigma):
    """(1/4) log sigma, fed to the noise embedding."""
    return 0.25 * torch.log(sigma)


def denoiser(p: EDMParams, net: Callable, xn: torch.Tensor,
             sigma: torch.Tensor) -> torch.Tensor:
    """D(x, sigma) = cskip x + cout net(cin x, cnoise).
    net: (x [B, T], cnoise [B, 1]) -> [B, T]; sigma [B] or [B, 1]."""
    if sigma.dim() == 1:
        sigma = sigma[:, None]
    return cskip(p, sigma) * xn + cout(p, sigma) * net(cin(p, sigma) * xn,
                                                       cnoise(p, sigma))


class EDM:
    """Object facade built from the config tree (``diff_params.callable``)."""

    def __init__(self, args):
        self.args = args
        self.params = EDMParams.from_args(args.diff_params)
