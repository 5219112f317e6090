"""aid_tpu_torch: the PyTorch / CUDA port of aid_tpu for an NVIDIA H100.

Guided long-gap audio inpainting with the CQTDiff+ octave U-Net: an
EDM-parameterised diffusion denoiser over an invertible octave-banded
constant-Q transform, sampled with a stochastic Heun sampler under
reconstruction guidance and data-consistency projection.

Layers, from the entry point down:
  serving.py   InpaintingService: gap finding, windows, chained long gaps
  sampling/    Sampler facade, Heun sampler + guided score, degradations
  diffusion/   EDM preconditioning and schedule
  models/      the octave U-Net (channels-last activations)
  ops/         CQT analysis/synthesis (torch.fft) and the fused
               norm x adaLN x GELU Triton kernel
  utils/       config composition, registry, weight conversion

The package imports torch, numpy, scipy and yaml, never JAX or aid_tpu.
Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
