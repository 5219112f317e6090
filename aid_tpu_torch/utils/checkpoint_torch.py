"""Load the reference PyTorch network's ``.pt`` checkpoints (the released
CQTDiff+ files carry ``{'it', 'network', 'optimizer', 'ema', 'args'}``).

The port's modules carry the reference's state-dict names, so no key is
translated: the weights are located in the payload, loaded strictly, and
cast to the dtype each tensor of the module is stored in (bf16 for the
serving network's conv and linear weights).

Locate order, as the JAX package's ``utils/checkpoint_torch.py``: ``ema``,
then ``network``, then ``state_dict``, then a ``model`` + ``ema_weights``
zip (EMA values under the model's names), then the payload itself with any
``diffusion.`` prefix stripped.
"""
from __future__ import annotations

from typing import Any, Dict

import torch


def find_state_dict(payload) -> Dict[str, Any]:
    """The network weights inside a reference checkpoint payload."""
    if not isinstance(payload, dict):
        raise ValueError("checkpoint payload is not a dict")
    for key in ("ema", "network", "state_dict"):
        sd = payload.get(key)
        if isinstance(sd, dict) and sd:
            return sd
    if "model" in payload and "ema_weights" in payload:
        return dict(zip(payload["model"].keys(), payload["ema_weights"]))
    if any(hasattr(v, "shape") for v in payload.values()):
        return {k.removeprefix("diffusion."): v for k, v in payload.items()}
    raise ValueError(f"no weights found; keys = {list(payload)[:8]}")


def _fir_buffer(key: str) -> bool:
    """The reference's resampling FIR kernels: buffers it saves, which the
    port builds from the config (the JAX converter skips them too)."""
    return key.endswith("kernel") and ("downsampler" in key or "upsampler" in key)


def load_into(module: torch.nn.Module, sd: Dict[str, Any]) -> None:
    """Copy ``sd`` into ``module``'s parameters and buffers of the same
    names, each cast to the module tensor's dtype and device. Apart from the
    reference's FIR buffers, every name must match both ways with equal
    shapes; otherwise this raises with the differences and leaves the
    module unchanged."""
    own = module.state_dict()
    sd = {k: v for k, v in sd.items() if not _fir_buffer(k)}
    missing = sorted(set(own) - set(sd))
    unexpected = sorted(set(sd) - set(own))
    shapes = [f"{k}: {tuple(sd[k].shape)} vs {tuple(own[k].shape)}"
              for k in own if k in sd and tuple(sd[k].shape) != tuple(own[k].shape)]
    if missing or unexpected or shapes:
        raise KeyError(f"checkpoint does not fit the network: {len(missing)} missing "
                       f"{missing[:8]}, {len(unexpected)} unexpected {unexpected[:8]}, "
                       f"{len(shapes)} of another shape {shapes[:8]}")
    module.load_state_dict({k: torch.as_tensor(sd[k]).to(own[k].dtype) for k in own})


def load_reference_checkpoint(path: str, module: torch.nn.Module) -> None:
    """Load the weights of a reference-layout ``.pt`` into ``module``. The
    file is fully unpickled (the reference's payload carries its config
    objects), so load only checkpoints from a trusted source."""
    load_into(module, find_state_dict(torch.load(path, map_location="cpu",
                                                 weights_only=False)))
