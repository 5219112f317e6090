"""Model introspection: shape assertion and the per-module parameter table
(port of ``aid_tpu/utils/summary.py``; the reference's
``print_module_summary`` and ``assert_shape``). The table is read from a
module's ``named_parameters()`` or from (name, shape) pairs, as a trainer
whose parameters are sharded keeps their full shapes."""
from __future__ import annotations

from typing import Iterable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

Named = Iterable[Tuple[str, Sequence[int]]]


def assert_shape(x, ref_shape: Sequence[Optional[int]]) -> None:
    """Raise unless x.shape matches ref_shape (None = wildcard dim)."""
    if len(x.shape) != len(ref_shape):
        raise AssertionError(
            f"wrong number of dims: got {len(x.shape)}, expected {len(ref_shape)}")
    for i, (got, want) in enumerate(zip(x.shape, ref_shape)):
        if want is not None and int(got) != int(want):
            raise AssertionError(f"dim {i}: got {got}, expected {want}")


def _named_shapes(params: Union[torch.nn.Module, Named]):
    if isinstance(params, torch.nn.Module):
        params = params.named_parameters()
    return [(name, tuple(int(d) for d in shape)) for name, shape in
            ((n, getattr(p, "shape", p)) for n, p in params)]


def param_table(params: Union[torch.nn.Module, Named], max_rows: int = 120) -> str:
    """A row per top-level child module, the TOTAL, and a row per tensor
    when there are at most ``max_rows`` of them."""
    rows = [(name, shape, int(np.prod(shape))) for name, shape in _named_shapes(params)]
    by_top = {}
    for name, _, n in rows:
        top = name.split(".")[0]
        by_top[top] = by_top.get(top, 0) + n
    lines = [f"{'module':58s} {'params':>12s}"]
    for name, n in sorted(by_top.items()):
        lines.append(f"{name:58s} {n:12,d}")
    lines.append("-" * 72)
    lines.append(f"{'TOTAL':58s} {sum(n for _, _, n in rows):12,d}")
    if len(rows) <= max_rows:
        lines.append("")
        for name, shape, n in rows:
            lines.append(f"  {name:70s} {str(shape):>20s} {n:10,d}")
    return "\n".join(lines)


def print_model_summary(params: Union[torch.nn.Module, Named]) -> int:
    """Print the table; returns the number of parameters."""
    named = _named_shapes(params)
    print(param_table(named), flush=True)
    return sum(int(np.prod(shape)) for _, shape in named)
