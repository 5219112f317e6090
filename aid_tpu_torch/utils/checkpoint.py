"""The port's training checkpoints, and resuming from the JAX package's.

Layout of a checkpoint (the reference trainer's, one ``torch.save`` file
``{exp_name}-{it}.pt``):

  it          int, iterations done
  network     {state-dict name: tensor}   parameters
  ema         {state-dict name: tensor}   EMA of the parameters
  optimizer   {"mu": {...}, "nu": {...}, "count": int}   Adam's moments
              (same names as the parameters) and step count
  gnorm_ema   float, the skip guardrail's running gradient-norm scale
  applied     int, steps applied (not reverted by a guardrail)

``save`` writes a temporary file and renames it, so a checkpoint on disk is
always whole. ``load`` also reads a JAX *stream* checkpoint
(``{exp_name}-{it}.ckpt/``): parameters, EMA and Adam's ``mu`` / ``nu``
share the parameter tree, so all four go through ``state_dict_from_flax``,
and a run started on a TPU resumes here with its optimizer state.
"""
from __future__ import annotations

import glob
import os
import re
from typing import Dict, List, Optional

import torch

from aid_tpu_torch.utils import ckpt_io
from aid_tpu_torch.utils.convert import state_dict_from_flax


def save(path: str, payload: Dict) -> str:
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def _adam_state(opt_state) -> Dict:
    """Adam's {count, mu, nu} out of an optax chain's state, which the stream
    format stores as a list of per-transform field dicts."""
    for s in opt_state if isinstance(opt_state, list) else [opt_state]:
        if isinstance(s, dict) and {"count", "mu", "nu"} <= set(s):
            return s
    raise ValueError("no Adam state (count, mu, nu) in the checkpoint's optimizer")


def from_jax(tree: Dict) -> Dict:
    """A JAX stream checkpoint's tree -> the port's payload."""
    it = int(tree.get("it", 0))
    out = {"it": it,
           "network": state_dict_from_flax(tree["network"]),
           "ema": state_dict_from_flax(tree.get("ema", tree["network"])),
           "gnorm_ema": float(tree.get("gnorm_ema", 0.0)),
           "applied": int(tree.get("applied", it))}
    if tree.get("optimizer") is not None:
        adam = _adam_state(tree["optimizer"])
        out["optimizer"] = {"mu": state_dict_from_flax(adam["mu"]),
                            "nu": state_dict_from_flax(adam["nu"]),
                            "count": int(adam["count"])}
    return out


def load(path: str) -> Dict:
    """A checkpoint in the port's layout, tensors on the CPU: a JAX stream
    directory is converted, a file is the port's own."""
    if os.path.isdir(path):
        return from_jax(ckpt_io.load(path))
    return torch.load(path, map_location="cpu", weights_only=True)


def list_checkpoints(model_dir: str, exp_name: Optional[str] = None) -> List[str]:
    """Checkpoints of ``exp_name`` (of any name without it) under
    ``model_dir``, oldest first: ``{name}-{it}.pt`` files and the JAX
    package's ``{name}-{it}.ckpt`` stream directories (at the same iteration
    the ``.pt`` comes last)."""
    prefix = re.escape(exp_name) if exp_name is not None else ".+"
    pat = re.compile(prefix + r"-(\d+)\.(pt|ckpt)$")
    found = []
    for p in glob.glob(os.path.join(os.path.abspath(model_dir), f"{exp_name or '*'}-*")):
        m = pat.search(os.path.basename(p))
        if m and (m.group(2) == "pt" or ckpt_io.is_stream(p)):
            found.append((int(m.group(1)), m.group(2) == "pt", p))
    return [p for _, _, p in sorted(found)]
