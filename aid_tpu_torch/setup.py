"""Component factories: config tree -> constructed objects (port of
``aid_tpu/setup.py`` and ``aid_tpu/models/bundle.py``). Configs name
components by ``callable:`` strings, resolved through the registry."""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from aid_tpu_torch.utils.registry import call_func_by_name


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another; with no CUDA and no explicit device this raises."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("aid_tpu_torch runs on a CUDA device; none is available "
                           "(pass device='cpu' to run on the CPU)")
    return torch.device("cuda")


def setup_network(args, device=None, state_dict: Optional[Dict[str, torch.Tensor]] = None,
                  seed: int = 0) -> torch.nn.Module:
    """The denoiser module from ``network.callable``, on its device, in
    inference mode (parameters frozen): weights from ``state_dict`` when
    given, else a seeded random init."""
    dev = resolve_device(device)
    net = call_func_by_name(args, func_name=args.network.callable)
    if state_dict is not None:
        net.load_state_dict(state_dict)
    else:
        net.init_weights(seed)
    net.store_weights_in_compute_dtype().requires_grad_(False)
    return net.to(dev).eval()


def setup_diff_parameters(args) -> Any:
    """EDM object (``diff_params.callable``)."""
    return call_func_by_name(args, func_name=args.diff_params.callable)


def setup_sampler(args, network, diff_params) -> Any:
    """Sampler facade (``tester.sampler_callable``)."""
    return call_func_by_name(network, diff_params, args,
                             func_name=args.tester.sampler_callable)
