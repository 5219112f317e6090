"""Task-level sampler facade (port of ``aid_tpu/sampling/sampler.py``):
unconditional generation and long/short-gap inpainting. The other tasks
(spectrogram inpainting, bandwidth extension, declipping, phase retrieval,
compressive sensing, autoregressive outpainting) wait for a later slice.

The tester's ``diff_params`` override applies at construction
(``same_as_training: False`` swaps in the test-time EDM parameters).
"""
from __future__ import annotations

from typing import Optional

import torch

from aid_tpu_torch.diffusion import edm
from aid_tpu_torch.sampling import degradations as degr
from aid_tpu_torch.sampling.heun import SamplerConfig, heun_sample, make_score_fn


class Sampler:
    def __init__(self, model, diff_params, args):
        """model: the UnetCQT module (on its device); diff_params: edm.EDM or
        EDMParams; args: the config tree."""
        self.model = model
        self.args = args
        p = diff_params.params if hasattr(diff_params, "params") else diff_params
        t = args.tester
        if not t.diff_params.same_as_training:
            p = edm.EDMParams.from_args(t.diff_params)
        self.p = p
        dc = t.data_consistency
        self.cfg = SamplerConfig(
            T=int(t.T), order=int(t.order),
            xi=float(t.posterior_sampling.xi),
            norm=t.posterior_sampling.norm,
            smoothl1_beta=float(t.posterior_sampling.get("smoothl1_beta", 1.0)),
            data_consistency=bool(dc.use) and dc.type == "always",
            data_consistency_end=bool(dc.use) and dc.type == "end",
            filter_out_cqt_DC_Nyq=bool(t.filter_out_cqt_DC_Nyq))
        self.smooth = bool(dc.use) and bool(dc.get("smooth", False))
        self.hann_size = int(dc.get("hann_size", 50))

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def _denoise(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        sigma = t.reshape(1, 1).expand(x.shape[0], 1).float()
        return edm.denoiser(self.p, self.model, x, sigma)

    def _hpf(self):
        cqt = getattr(self.model, "cqt", None)
        return None if cqt is None else cqt.apply_hpf_DC

    def predict_unconditional(self, shape, generator: Optional[torch.Generator] = None,
                              prior=None, churn=None) -> torch.Tensor:
        score = make_score_fn(self.p, self.cfg, self._denoise, hpf=self._hpf())
        return heun_sample(tuple(shape), self.p, self.cfg, score, prior=prior,
                           churn=churn, generator=generator, device=self.device)

    def predict_inpainting(self, y_masked: torch.Tensor, mask: torch.Tensor,
                           generator: Optional[torch.Generator] = None,
                           prior=None, churn=None) -> torch.Tensor:
        """Long/short-gap inpainting: the degradation is the mask multiply;
        the projection uses the Hann-smoothed mask (each row its own)."""
        if self.smooth:
            smooth = torch.from_numpy(degr.make_smooth_mask(
                mask.detach().cpu().numpy(), self.hann_size)).to(mask.device)
        else:
            smooth = mask
        proj = degr.inpainting_projector(y_masked, smooth)
        score = make_score_fn(self.p, self.cfg, self._denoise, y=y_masked,
                              degradation=degr.time_mask(mask), proj=proj,
                              hpf=self._hpf())
        return heun_sample(tuple(y_masked.shape), self.p, self.cfg, score,
                           proj_end=proj, prior=prior, churn=churn,
                           generator=generator, device=y_masked.device)
