"""Task-level sampler facade (port of ``aid_tpu/sampling/sampler.py``):
unconditional generation, long/short-gap inpainting, spectrogram
inpainting, bandwidth extension, declipping, phase retrieval, compressive
sensing and autoregressive outpainting.

Every task, with or without ``rid`` recording, runs through a
``sampling.program.HeunProgram`` cached per (the JAX package's task key,
the shapes and dtypes of its buffers, sampler config, device, fused
function, weights): CUDA graphs of the guided-Heun step on the card, the
same steps eagerly on the CPU (``heun_sample``'s result bit for bit). A
new value of a traced argument of the JAX program (a mask, a clip value,
an observation) reuses the program; a new BWE filter builds another.
``compile_inpainting`` builds the inpainting program without running it.
A trajectory whose network makes collectives (split over tp ranks or
context-parallel: ``parallel.mesh.communicates``) builds the same task's
operators over the request's tensors and runs ``heun_sample`` eagerly; one
that makes none runs its program also under a process group (a rank of a
dp mesh runs its rows through its own programs).

Noise is drawn from ``generator`` unless the standard-normal ``prior``
[B, L] and ``churn`` [T, B, L] are injected, in ``heun_sample``'s order
(the prior first), outside any graph. With ``rid`` each call returns
(x, Record) instead of x.

The tester's ``diff_params`` override applies at construction
(``same_as_training: False`` swaps in the test-time EDM parameters).
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
from typing import Optional, Sequence

import torch

from aid_tpu_torch.diffusion import edm
from aid_tpu_torch.ops import fused_adaln as fa
from aid_tpu_torch.parallel import mesh as pmesh
from aid_tpu_torch.sampling import degradations as degr
from aid_tpu_torch.sampling import program
from aid_tpu_torch.sampling.heun import SamplerConfig, draw_noise, heun_sample, make_score_fn
from aid_tpu_torch.sampling.program import HeunProgram, Task
from aid_tpu_torch.utils.graphs import capture_flags, specs, tensors_key


def denoise_at(p: edm.EDMParams, model, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """D(x, t) with one sigma, the 0-dim ``t``, for every row."""
    sigma = t.reshape(1, 1).expand(x.shape[0], 1).float()
    return edm.denoiser(p, model, x, sigma)


class Sampler:
    def __init__(self, model, diff_params, args, rid: bool = False):
        """model: the UnetCQT module (on its device); diff_params: edm.EDM or
        EDMParams; args: the config tree; rid: record every trajectory."""
        self.model = model
        self.args = args
        self.rid = rid
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
            filter_out_cqt_DC_Nyq=bool(t.filter_out_cqt_DC_Nyq),
            record=rid)
        self.smooth = bool(dc.use) and bool(dc.get("smooth", False))
        self.hann_size = int(dc.get("hann_size", 50))
        self._programs = {}
        self._weights = None
        self._pool = None

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def noise_rows(self, shape, rows: torch.Tensor,
                   generator: Optional[torch.Generator] = None):
        """(prior, churn) of the batch rows ``rows`` (indices into dim 0 of
        ``shape``), drawn at the whole batch's ``shape`` as an unsplit call
        would draw them: a batch split over ranks gets the noise of the
        one-device run."""
        prior, churn = draw_noise(shape, self.cfg.T, generator, self.device)
        return prior[rows], churn[:, rows]

    def _denoise(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        return denoise_at(self.p, self.model, x, t)

    def _hpf(self):
        cqt = getattr(self.model, "cqt", None)
        return None if cqt is None else cqt.apply_hpf_DC

    def _generic_cfg(self) -> SamplerConfig:
        """The tasks of the reference's generic sampler (bandwidth extension,
        declipping, phase retrieval, compressive sensing) place the guidance
        epsilon as s = t^2 xi / (|g|/sqrt(L) t + eps)."""
        return dataclasses.replace(self.cfg, guidance_eps="generic")

    def _run(self, task: Task, cfg: SamplerConfig, shape, generator, prior, churn,
             **inputs):
        """One trajectory of ``task`` over ``inputs``: its program, or, where
        programs are off, ``heun_sample`` over the same operators built on
        the request's tensors. The noise is drawn here, outside any graph."""
        shape = tuple(shape)
        if prior is None or churn is None:
            prior, churn = draw_noise(shape, cfg.T, generator, self.device, prior, churn)
        if not self.programs_enabled():
            ops = task.ops(inputs)
            score = make_score_fn(self.p, cfg, self._denoise, y=ops.y,
                                  degradation=ops.degradation, proj=ops.proj, hpf=self._hpf())
            return heun_sample(shape, self.p, cfg, score, proj_end=ops.proj_end, prior=prior,
                               churn=churn, device=self.device)
        buffers = {"x": (shape, prior.dtype), "z": (shape, churn.dtype),
                   **specs(inputs)}
        return self._program(task, cfg, buffers).run(prior, churn, **inputs)

    # -------------------------------------------------------------- programs

    def _weights_key(self) -> tuple:
        """``tensors_key`` of every parameter and buffer."""
        return tensors_key(itertools.chain(self.model.parameters(), self.model.buffers()))

    def programs_enabled(self) -> bool:
        """Programs serve every trajectory that makes no collective, under
        any process group; a network split over tp ranks or context-parallel
        runs eagerly, by rule (its collectives would have to sit inside the
        graphs, which NCCL alone can hold, and only across cards)."""
        return not pmesh.communicates(self.model)

    def release_programs(self) -> None:
        """Drop every cached program and the graph pool they share."""
        self._programs.clear()
        self._pool = None

    def _cached_program(self, task_key, build) -> HeunProgram:
        """One program per (task key, fused function, weights): the fused
        function is looked up at call time (a patched plain version builds
        its own program), and programs of weights that were replaced or
        loaded in place are dropped, never replayed."""
        weights = self._weights_key()
        if weights != self._weights:
            self.release_programs()
            self._weights = weights
        key = (task_key, fa.norm_adaln_gelu)
        prog = self._programs.get(key)
        if prog is None:
            prog = self._programs[key] = build()
        return prog

    def _program(self, task: Task, cfg: SamplerConfig, buffers: dict) -> HeunProgram:
        """The cached program of ``task`` under ``cfg`` for ``buffers``
        ({name: (shape, dtype)}), built on a miss."""
        dev = self.device
        if dev.type == "cuda" and self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        key = (task.key, tuple(sorted((k, tuple(s), str(d)) for k, (s, d) in buffers.items())),
               cfg, dev, capture_flags(self.model))
        # the program holds the model, not the sampler: dropping the sampler
        # frees its programs and their graph pool without a garbage collection
        denoise = functools.partial(denoise_at, self.p, self.model)
        return self._cached_program(key, lambda: HeunProgram(
            task, self.p, cfg, denoise, buffers, dev, hpf=self._hpf(), pool=self._pool))

    def _smooth_mask(self, mask: torch.Tensor) -> torch.Tensor:
        """The Hann-smoothed mask (each row its own), computed on the host."""
        if not self.smooth:
            return mask
        return torch.from_numpy(degr.make_smooth_mask(
            mask.detach().cpu().numpy(), self.hann_size)).to(mask.device)

    def compile_inpainting(self, y_masked: torch.Tensor, mask: torch.Tensor) -> HeunProgram:
        """Build (capture, on CUDA) the inpainting program that
        ``predict_inpainting`` runs for these shapes and dtypes, noise drawn
        in the default dtype, without running a trajectory; returns it (its
        ``memory_bytes()`` drives ``InpaintingService.autotune_max_batch``)."""
        noise, shape = torch.get_default_dtype(), tuple(y_masked.shape)
        return self._program(program.inpainting(), self.cfg, {
            "x": (shape, noise), "z": (shape, noise), "y": (shape, y_masked.dtype),
            "mask": (tuple(mask.shape), mask.dtype),
            "smooth": (tuple(mask.shape), torch.float32 if self.smooth else mask.dtype)})

    def _inpaint(self, y_masked, mask, smooth, generator, prior, churn):
        """Inpainting with the projection's ``smooth`` mask."""
        return self._run(program.inpainting(), self.cfg, y_masked.shape, generator, prior,
                         churn, y=y_masked, mask=mask, smooth=smooth)

    # ----------------------------------------------------------------- tasks

    def predict_unconditional(self, shape, generator: Optional[torch.Generator] = None,
                              prior=None, churn=None):
        return self._run(program.unconditional(), self.cfg, shape, generator, prior, churn)

    def predict_inpainting(self, y_masked: torch.Tensor, mask: torch.Tensor,
                           generator: Optional[torch.Generator] = None,
                           prior=None, churn=None):
        """Long/short-gap inpainting: the degradation is the mask multiply;
        the projection uses the Hann-smoothed mask (each row its own)."""
        return self._inpaint(y_masked, mask, self._smooth_mask(mask), generator, prior, churn)

    def predict_spectrogram_inpainting(self, y_masked: torch.Tensor, mask_FT: torch.Tensor,
                                       generator: Optional[torch.Generator] = None,
                                       prior=None, churn=None):
        """Inpainting of a (F, frames) STFT-domain mask: the degradation is
        the masked resynthesis A; the projection is y + x - A(x)."""
        task = program.spectrogram_inpainting(self.args.tester.spectrogram_inpainting.stft)
        return self._run(task, self.cfg, y_masked.shape, generator, prior, churn, y=y_masked,
                         mask_FT=mask_FT)

    def predict_bwe(self, y_lowpassed: torch.Tensor, fc: float, fs: float,
                    filter_type: str = "firwin", order: int = 200,
                    generator: Optional[torch.Generator] = None, prior=None, churn=None):
        """Bandwidth extension: the degradation is the lowpass LPF
        (``degradations.bwe_lowpass``); the projection is y + x - LPF(x).
        ``y_lowpassed`` is the observation LPF(clean)."""
        return self._run(program.bwe(filter_type, order, fc, fs), self._generic_cfg(),
                         y_lowpassed.shape, generator, prior, churn, y=y_lowpassed)

    def predict_declipping(self, y_clipped: torch.Tensor, clip_value,
                           generator: Optional[torch.Generator] = None, prior=None,
                           churn=None):
        """Declipping: guidance through the hard clip, no projection."""
        cv = torch.as_tensor(clip_value, dtype=torch.float32, device=y_clipped.device)
        return self._run(program.declipping(), self._generic_cfg(), y_clipped.shape,
                         generator, prior, churn, y=y_clipped, clip_value=cv)

    def predict_phase_retrieval(self, y_mag: torch.Tensor, shape,
                                generator: Optional[torch.Generator] = None, prior=None,
                                churn=None):
        """Phase retrieval: guidance through |STFT(x)|, no projection."""
        task = program.phase_retrieval(shape, self.args.tester.spectrogram_inpainting.stft)
        return self._run(task, self._generic_cfg(), shape, generator, prior, churn,
                         y_mag=y_mag)

    def predict_compsens(self, y_subsampled: torch.Tensor, mask: torch.Tensor,
                         generator: Optional[torch.Generator] = None, prior=None,
                         churn=None):
        """Compressive sensing: guidance through the random sample mask, with
        data consistency off (the reference asserts it off)."""
        cfg = dataclasses.replace(self._generic_cfg(), data_consistency=False,
                                  data_consistency_end=False)
        return self._run(program.compsens(), cfg, y_subsampled.shape, generator, prior, churn,
                         y=y_subsampled, mask=mask)

    def predict_autoregressive(self, num_segments: int, overlap: float = 0.25,
                               shape=None, generator: Optional[torch.Generator] = None,
                               priors: Optional[Sequence[torch.Tensor]] = None,
                               churns: Optional[Sequence[torch.Tensor]] = None
                               ) -> torch.Tensor:
        """Outpainting by chained windows: segment 0 is unconditional; each
        next segment is inpainting conditioned on the trailing ``overlap``
        of the previous one, projected with the un-smoothed mask. Returns
        [B, L + (num_segments - 1)(L - n_ov)]; ``priors``/``churns`` give
        one noise draw per segment."""
        if shape is None:
            shape = (1, int(self.args.exp.audio_len))
        B, L = shape
        n_ov = int(L * overlap)
        dev = self.device
        mask = torch.zeros((B, L), device=dev)
        mask[:, :n_ov] = 1.0

        def noise(i):
            return (None if priors is None else priors[i],
                    None if churns is None else churns[i])

        prior, churn = noise(0)
        seg = self.predict_unconditional(shape, generator, prior=prior, churn=churn)
        if self.rid:
            seg = seg[0]
        out = [seg]
        for i in range(1, num_segments):
            y = torch.zeros((B, L), device=dev)
            y[:, :n_ov] = seg[:, -n_ov:]
            y = y * mask
            prior, churn = noise(i)
            seg = self._inpaint(y, mask, mask, generator, prior, churn)
            if self.rid:
                seg = seg[0]
            out.append(seg[:, n_ov:])
        return torch.cat(out, dim=1)
