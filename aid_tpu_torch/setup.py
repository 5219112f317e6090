"""Component factories: config tree -> constructed objects (port of
``aid_tpu/setup.py`` and ``aid_tpu/models/bundle.py``). Configs name
components by ``callable:`` strings, resolved through the registry."""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from aid_tpu_torch.utils.registry import call_func_by_name


_SHARED_CARD_SAID = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the one the caller names, else
    CUDA; with no CUDA and no explicit device this raises. Under a process
    group rank ``LOCAL_RANK`` takes card ``LOCAL_RANK % device_count``:
    its own card, or, when the ranks outnumber the cards, a card shared with
    other ranks (said once)."""
    global _SHARED_CARD_SAID
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("aid_tpu_torch runs on a CUDA device; none is available "
                           "(pass device='cpu' to run on the CPU)")
    import torch.distributed as dist
    if not dist.is_initialized():
        return torch.device("cuda")
    import os
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    n = torch.cuda.device_count()
    ranks = int(os.environ.get("LOCAL_WORLD_SIZE", dist.get_world_size()))
    if ranks > n and not _SHARED_CARD_SAID:
        print(f"[setup] shared-card mode: {ranks} ranks on {n} card(s), rank "
              f"{local} on cuda:{local % n}", flush=True)
        _SHARED_CARD_SAID = True
    return torch.device(f"cuda:{local % n}")


def setup_network(args, device=None, state_dict: Optional[Dict[str, torch.Tensor]] = None,
                  seed: int = 0, trainable: bool = False) -> torch.nn.Module:
    """The denoiser module from ``network.callable`` on its device, weights
    from ``state_dict`` when given, else a seeded random init. For serving
    (the default) the parameters are frozen and stored in the compute dtype;
    ``trainable`` keeps f32 parameters that record gradients (the RFF
    frequencies stay frozen, as in the reference)."""
    dev = resolve_device(device)
    net = call_func_by_name(args, func_name=args.network.callable)
    if state_dict is not None:
        net.load_state_dict(state_dict)
    else:
        net.init_weights(seed)
    if trainable:
        return net.to(dev).train()
    net.store_weights_in_compute_dtype().requires_grad_(False)
    return net.to(dev).eval()


def setup_dataset(args) -> Any:
    """Infinite training-batch iterator yielding (audio [B, T], fs [B]) numpy
    batches of this rank's share of ``exp.batch`` (all of it without a
    process group): ``exp.num_workers`` decode processes, or one prefetch
    thread. Each rank draws from its own stream."""
    from aid_tpu_torch.data.loader import MultiProcessLoader, make_train_loader
    from aid_tpu_torch.parallel import mesh as pmesh
    rows = pmesh.local_batch_size(int(args.exp.batch), pmesh.world_size())
    nw = int(args.exp.get("num_workers", 0))
    if nw > 0:
        return MultiProcessLoader(args, str(args.dset.callable), rows, nw, rank=pmesh.rank())
    ds = call_func_by_name(args, func_name=args.dset.callable)
    return make_train_loader(iter(ds), rows)


def setup_dataset_test(args) -> Any:
    """Finite test set yielding (audio, fs, filename)."""
    return call_func_by_name(args, func_name=args.dset.test.callable)


def setup_diff_parameters(args) -> Any:
    """EDM object (``diff_params.callable``)."""
    return call_func_by_name(args, func_name=args.diff_params.callable)


def setup_tester(args, network=None, diff_params=None, test_set=None, device=None,
                 in_training=False) -> Optional[Any]:
    """Tester (``tester.callable``) on ``device`` (CUDA unless named);
    None when ``tester.do_test`` is off, unless it is for training's demos."""
    dev = resolve_device(device)
    if not bool(args.tester.get("do_test", True)) and not in_training:
        return None
    return call_func_by_name(args=args, network=network, diff_params=diff_params,
                             test_set=test_set, in_training=in_training, device=dev,
                             func_name=args.tester.callable)


def setup_trainer(args, dset=None, network=None, diff_params=None, tester=None) -> Any:
    """Trainer (``exp.trainer_callable``)."""
    return call_func_by_name(args, dset, network, diff_params, tester,
                             func_name=args.exp.trainer_callable)


def setup_sampler(args, network, diff_params, rid: bool = False) -> Any:
    """Sampler facade (``tester.sampler_callable``); ``rid`` records every
    trajectory."""
    return call_func_by_name(network, diff_params, args, rid=rid,
                             func_name=args.tester.sampler_callable)
