"""Carry weights across: the JAX package's parameter tree -> the port's
state dict.

The port's modules carry the reference PyTorch network's state-dict names,
so the map is the JAX package's flax-path -> reference-key export (its
``utils/checkpoint_torch.py``), kept here as the port's own copy:

  flax path                          state-dict key
  embedding/rff_freq                 embedding.RFF_freq
  embedding/mlp_{k}/{kernel,bias}    embedding.MLP.{k}.{weight (.T), bias}
  down_{i}_init|pyr|res/*            downs.{i}.0 | downs.{i}.1.weight | downs.{i}.2
  mid_{m}_out|res/*                  middle.{m}.0 | middle.{m}.1
  up_{j}_out|res/*                   ups.{j}.0 | ups.{j}.1
  conv_{k}/kernel (HWIO)             H.{k}.weight (OIHW)
  norm_{k}/gamma [N]                 norm.{k}.gamma [1, N, 1, 1]
  affine_{k}, gate_{k}               affine.{k}, gate.{k}
  norm_attn, affine_attn, gate_attn  norm2, affine2, gate2
  attn/{proj_in,proj_out,qk,rel_pos} attn_block.{proj_in,proj_out,qk,
                                     rel_pos.relative_attention_bias}
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch


def flax_key_to_torch(path: Tuple[str, ...]) -> str:
    """Flax parameter path -> reference state-dict key."""
    top = path[0]
    if top == "embedding":
        if path[1] == "rff_freq":
            return "embedding.RFF_freq"
        k = path[1].split("_")[1]
        return f"embedding.MLP.{k}." + ("weight" if path[2] == "kernel" else "bias")
    if top.startswith("fenc_"):
        return f"freq_encodings.{top.split('_')[1]}.rff_freq"
    if top.startswith("down_"):
        _, i, what = top.split("_")
        if what == "pyr":
            return f"downs.{i}.1.weight"
        prefix = {"init": f"downs.{i}.0", "res": f"downs.{i}.2"}[what]
    elif top.startswith("mid_"):
        _, m, what = top.split("_")
        prefix = f"middle.{m}." + ("0" if what == "out" else "1")
    elif top.startswith("up_"):
        _, j, what = top.split("_")
        prefix = f"ups.{j}." + ("0" if what == "out" else "1")
    else:
        raise KeyError(f"unmapped flax path {path!r}")
    rest = path[1:]
    h = rest[0]
    if h in ("proj_in", "proj_out", "res_conv"):
        return f"{prefix}.{h}.weight"
    if h.startswith("conv_"):
        return f"{prefix}.H.{h.split('_')[1]}.weight"
    if h == "norm_attn":
        return f"{prefix}.norm2.gamma"
    if h in ("affine_attn", "gate_attn"):
        leaf = "weight" if rest[1] == "kernel" else "bias"
        return f"{prefix}.{h.split('_')[0]}2.{leaf}"
    if h.startswith("norm_"):
        return f"{prefix}.norm.{h.split('_')[1]}.gamma"
    if h.startswith(("affine_", "gate_")):
        kind, k = h.split("_")
        leaf = "weight" if rest[1] == "kernel" else "bias"
        return f"{prefix}.{kind}.{k}.{leaf}"
    if h == "attn":
        sub = rest[1]
        if sub == "rel_pos":
            return f"{prefix}.attn_block.rel_pos.relative_attention_bias.weight"
        leaf = "weight" if rest[2] == "kernel" else "bias"
        return f"{prefix}.attn_block.{sub}.{leaf}"
    raise KeyError(f"unmapped flax path {path!r}")


def flax_value_to_torch(path: Tuple[str, ...], v) -> np.ndarray:
    """Flax leaf -> the reference tensor layout (f32)."""
    v = np.asarray(v, np.float32)
    leaf, parent = path[-1], path[-2] if len(path) >= 2 else ""
    if leaf == "gamma":
        return v.reshape(1, -1, 1, 1)
    if leaf in ("rff_freq", "embedding", "bias"):
        return v
    if parent == "qk":                      # [HF, 2HF] -> Conv1d [2HF, HF, 1]
        return v.T[:, :, None]
    if v.ndim == 4:                         # HWIO -> OIHW
        return v.transpose(3, 2, 0, 1)
    if v.ndim == 2:                         # [in, out] -> Linear [out, in]
        return v.T
    raise ValueError(f"unhandled tensor at {'/'.join(path)}: shape {v.shape}")


def _leaves(tree, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], object]]:
    if hasattr(tree, "shape"):
        yield prefix, tree
        return
    for k, v in tree.items():
        yield from _leaves(v, prefix + (str(k),))


def state_dict_from_flax(params) -> Dict[str, torch.Tensor]:
    """The JAX package's parameter tree (nested dicts of arrays, with or
    without a top-level ``"params"``) -> the port's state dict. Every leaf
    maps to exactly one key; a duplicate raises."""
    tree = params["params"] if "params" in params else params
    out: Dict[str, torch.Tensor] = {}
    for path, v in _leaves(tree):
        key = flax_key_to_torch(path)
        if key in out:
            raise KeyError(f"duplicate state-dict key {key} from {path}")
        out[key] = torch.from_numpy(flax_value_to_torch(path, v).copy())
    return out
