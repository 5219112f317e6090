"""Read the JAX package's *stream* checkpoints with numpy alone.

A stream checkpoint is a directory:

  {name}.ckpt/
    stream_manifest.json   nested tree; each array leaf is {"__npy__": file}
    a00000.npy ...         one file per array leaf

``load`` rebuilds the tree as plain containers: dicts, lists (optax's
NamedTuple states arrive as field-name dicts), numpy arrays and scalars.
Older JAX checkpoints written by orbax have no manifest; the JAX package
converts them to this format (``python scripts/orbax_to_stream.py IN OUT``).
"""
from __future__ import annotations

import json
import os

import numpy as np

MANIFEST = "stream_manifest.json"


def is_stream(path: str) -> bool:
    return os.path.exists(os.path.join(path, MANIFEST))


def load(path: str):
    """The checkpoint's tree, every array leaf as a numpy array."""
    path = os.path.abspath(path)
    if not is_stream(path):
        raise ValueError(
            f"{path!r} is not a stream checkpoint (no {MANIFEST}); convert an orbax "
            "checkpoint with the JAX package first: python scripts/orbax_to_stream.py "
            f"{path} OUT.ckpt")
    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)

    def walk(node):
        if isinstance(node, dict):
            if set(node.keys()) == {"__npy__"}:
                return np.load(os.path.join(path, node["__npy__"]), allow_pickle=False)
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node

    return walk(manifest)
