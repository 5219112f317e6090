"""String-callable registry: configs name components by dotted path (the
port's own copy of the JAX package's ``utils/registry.py``)."""
from __future__ import annotations

import importlib
from typing import Any


def get_obj_by_name(name: str) -> Any:
    """Resolve a dotted path (``pkg.module.Object``) to a Python object."""
    parts = name.split(".")
    for i in range(len(parts) - 1, 0, -1):
        try:
            obj: Any = importlib.import_module(".".join(parts[:i]))
        except ImportError:
            continue
        try:
            for attr in parts[i:]:
                obj = getattr(obj, attr)
        except AttributeError:
            continue
        return obj
    raise ImportError(f"Cannot resolve object by name: {name!r}")


def call_func_by_name(*args: Any, func_name: str, **kwargs: Any) -> Any:
    """Construct/call the object named by ``func_name`` with the given args."""
    return get_obj_by_name(func_name)(*args, **kwargs)
