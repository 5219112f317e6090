"""Attribute-access dict container (the port's own copy of the JAX
package's ``utils/containers.py``): a dict with attribute access that wraps
nested mappings, so a composed YAML config tree reads as ``args.network.Ns``.
"""
from __future__ import annotations

from typing import Any, Mapping


class EasyDict(dict):
    """dict with attribute access; recursively wraps nested mappings."""

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        super().__init__(*args, **kwargs)
        for k, v in list(self.items()):
            self[k] = _wrap(v)

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = _wrap(value)

    def __setitem__(self, name: str, value: Any) -> None:
        super().__setitem__(name, _wrap(value))

    def __delattr__(self, name: str) -> None:
        del self[name]

    def to_dict(self) -> dict:
        """A plain nested dict (lists in place of tuples), as YAML writes it."""
        def unwrap(v: Any) -> Any:
            if isinstance(v, EasyDict):
                return {k: unwrap(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return [unwrap(x) for x in v]
            return v

        return unwrap(self)


def _wrap(v: Any) -> Any:
    if isinstance(v, EasyDict):
        return v
    if isinstance(v, Mapping):
        return EasyDict(v)
    if isinstance(v, list):
        return [_wrap(x) for x in v]
    return v
