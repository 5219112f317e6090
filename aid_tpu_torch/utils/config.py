"""Hydra-style YAML config-group composition (the port's own copy of the JAX
package's ``utils/config.py``, reading ``aid_tpu_torch/configs``).

A root config declares ``defaults: [{group: name}, ...]``; each group loads
``configs/<group>/<name>.yaml`` under ``args.<group>``; overrides are dotted
paths (``exp.audio_len=2048``) or group swaps (``network=other``). A group
file holding ``_alias: other`` stands for ``other`` (see ``_resolve_alias``).
Values are parsed with ``yaml.safe_load`` so ``1e-4``, ``[1,2]``, ``True``
and ``None`` round-trip.
"""
from __future__ import annotations

import copy
import os
import re
import sys
from typing import Any, Dict, List, Optional, Sequence

import yaml

from aid_tpu_torch.utils.containers import EasyDict

DEFAULT_CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "configs")

_NUM_RE = re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)[eE][+-]?\d+$")


def _coerce(v: Any) -> Any:
    """YAML 1.1 reads '1e-4' as a string; coerce it (and literal 'None')."""
    if isinstance(v, dict):
        return {k: _coerce(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_coerce(x) for x in v]
    if isinstance(v, str) and _NUM_RE.match(v):
        return float(v)
    if v == "None":
        return None
    return v


def _load_yaml(path: str) -> dict:
    with open(path, "r") as f:
        out = yaml.safe_load(f)
    return _coerce(out) or {}


def _set_dotted(tree: dict, dotted: str, value: Any) -> None:
    intentional = dotted.startswith("+")   # hydra-style "add new key" marker
    keys = dotted.lstrip("+").split(".")
    node = tree
    fresh = False
    for k in keys[:-1]:
        if k not in node or not isinstance(node[k], dict):
            node[k] = {}
            fresh = True
        node = node[k]
    if (fresh or keys[-1] not in node) and not intentional:
        print(f"[config] NOTE: override creates NEW key {dotted!r} "
              "(not present in the composed config; typo?)", file=sys.stderr)
    node[keys[-1]] = value


def parse_value(text: str) -> Any:
    try:
        return _coerce(yaml.safe_load(text))
    except yaml.YAMLError:
        return text


def compose(config_dir: str = DEFAULT_CONFIG_DIR, config_name: str = "conf",
            overrides: Optional[Sequence[str]] = None) -> EasyDict:
    """Compose the config tree: root config + group files + overrides.
    Returns a nested EasyDict with the group names as top-level keys."""
    root = _load_yaml(os.path.join(config_dir, config_name + ".yaml"))
    group_choice: Dict[str, str] = {}
    for entry in root.pop("defaults", []):
        if isinstance(entry, dict):
            for group, name in entry.items():
                group_choice[str(group)] = str(name)

    dotted: List[tuple] = []
    for ov in overrides or []:
        if "=" not in ov:
            raise ValueError(f"Override must be key=value, got {ov!r}")
        key, _, val = ov.partition("=")
        key = key.strip()
        if key in group_choice:
            group_choice[key] = val.strip()
        else:
            dotted.append((key, parse_value(val)))

    tree: dict = dict(root)
    for group, name in group_choice.items():
        loaded, name = _resolve_alias(config_dir, group, name)
        tree[group] = loaded
        tree[group]["name"] = tree[group].get("name", name)
    for key, val in dotted:
        _set_dotted(tree, key, val)
    return EasyDict(tree)


def _resolve_alias(config_dir: str, group: str, name: str):
    """Load ``configs/<group>/<name>.yaml``, following ``_alias: other``
    files (the reference's own config names, e.g.
    ``network=paper_1912_unet_cqt_oct_attention_44k_2``) to the file they
    name. Keys beside ``_alias`` are deep-merged over the target, the most
    specific file winning. A cycle raises. Returns (tree, resolved name)."""
    seen = set()
    overlays = []
    while True:
        if name in seen:
            raise ValueError(f"config alias cycle in group {group!r}: {sorted(seen)}")
        seen.add(name)
        loaded = _load_yaml(os.path.join(config_dir, group, name + ".yaml"))
        target = loaded.pop("_alias", None)
        if target is None:
            break
        if loaded:
            overlays.append(loaded)
        name = str(target)
    for over in reversed(overlays):
        loaded = _deep_merge(loaded, over)
    return loaded, name


def _deep_merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def save_config(args: EasyDict, path: str) -> None:
    """Write a composed config tree as YAML."""
    with open(path, "w") as f:
        yaml.safe_dump(args.to_dict(), f, sort_keys=False)


def load_saved_config(path: str) -> EasyDict:
    """A config tree written by ``save_config``."""
    return EasyDict(_load_yaml(path))


def merge_config(args: EasyDict, over: dict) -> EasyDict:
    """``args`` with ``over`` deep-merged on top (``over`` wins)."""
    return EasyDict(_deep_merge(args.to_dict(), copy.deepcopy(over)))
