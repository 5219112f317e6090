"""The port's config tree (``aid_tpu_torch/configs``) against the JAX
package's (``aid_tpu/configs``).

Every ``<group>/<name>.yaml`` of the JAX tree has a port counterpart, and
selecting it in both composers gives the same tree, except ``callable``
values (the port names ``aid_tpu_torch`` functions) and the keys listed in
``PORT_ONLY``. The reference's ``paper_1912_*`` names resolve through
``_alias`` files; alias overlays deep-merge; a cycle raises.
"""
import json
import os

import pytest

from aid_tpu.utils.config import DEFAULT_CONFIG_DIR as JAX_DIR
from aid_tpu.utils.config import compose as jax_compose
from aid_tpu_torch.utils.config import DEFAULT_CONFIG_DIR as PORT_DIR
from aid_tpu_torch.utils.config import compose

# Keys that only the port's files carry, with the value each must have and
# why. The port's exp files all carry the trainer keys of maestro22k_8s; where
# the JAX file has no such key, the port's value is the JAX trainer's
# default for it (aid_tpu/training/trainer.py), so both trainers run alike.
PORT_ONLY = {
    "exp.skip_grad_norm": 0,      # JAX default: exp.get("skip_grad_norm", 0)
    "exp.skip_grad_factor": 0,    # JAX default: exp.get("skip_grad_factor", 0)
    "exp.stall_timeout_s": 1800,  # JAX default: exp.get("stall_timeout_s", 1800.0)
    "exp.max_host_rss_gb": 0,     # JAX default: exp.get("max_host_rss_gb", 0)
}


def _jax_files():
    return sorted((g, f[:-5]) for g in os.listdir(JAX_DIR)
                  if os.path.isdir(os.path.join(JAX_DIR, g))
                  for f in os.listdir(os.path.join(JAX_DIR, g)) if f.endswith(".yaml"))


def _plain(tree):
    return json.loads(json.dumps(tree))


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "."))
        else:
            out[key] = v
    return out


def test_every_jax_config_has_a_port_counterpart():
    files = _jax_files()
    assert len(files) == 24
    missing = [f"{g}/{n}" for g, n in files
               if not os.path.exists(os.path.join(PORT_DIR, g, n + ".yaml"))]
    assert not missing


@pytest.mark.parametrize("group,name", _jax_files(), ids=lambda v: str(v))
def test_composed_tree_equals_jax(group, name):
    ov = [f"{group}={name}"]
    port = _flatten(_plain(compose(overrides=ov)))
    ref = _flatten(_plain(jax_compose(overrides=ov)))
    for key, value in PORT_ONLY.items():
        if key not in ref:
            assert port.pop(key) == value, key
    assert set(port) == set(ref)
    for key, value in ref.items():
        if key.endswith("callable"):
            assert value.startswith("aid_tpu.") and port[key] == "aid_tpu_torch." + value[8:]
        else:
            assert port[key] == value, key


@pytest.mark.parametrize("alias,target", [
    ("paper_1912_unet_cqt_oct_attention_44k_2", "cqtdiff_plus_44k"),
    ("paper_1912_unet_cqt_oct_attention_adaLN_2", "cqtdiff_plus_22k"),
    ("paper_1912_unet_cqt_oct_noattention_adaln", "cqtdiff_plus_22k_noattention")])
def test_reference_network_names_resolve(alias, target):
    got = compose(overrides=[f"network={alias}"]).network
    assert got == compose(overrides=[f"network={target}"]).network
    assert got.name == "unet_cqt_oct_with_attention" and "_alias" not in got


def _tree(tmp_path, files):
    for rel, text in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(text)
    return str(tmp_path)


def test_alias_chain_deep_merges_its_overlays(tmp_path):
    d = _tree(tmp_path, {
        "conf.yaml": "defaults:\n  - net: outer\n",
        "net/base.yaml": "depth: 7\ncqt:\n  num_octs: 7\n  bins: 64\nNs: [1, 2]\n",
        "net/inner.yaml": "_alias: base\ncqt:\n  num_octs: 8\n",
        "net/outer.yaml": "_alias: inner\ndepth: 9\n"})
    for c in (compose, jax_compose):
        net = c(config_dir=d, overrides=[]).net
        assert _plain(net) == {"depth": 9, "cqt": {"num_octs": 8, "bins": 64}, "Ns": [1, 2],
                               "name": "base"}


def test_alias_cycle_raises(tmp_path):
    d = _tree(tmp_path, {"conf.yaml": "defaults:\n  - net: a\n",
                         "net/a.yaml": "_alias: b\n", "net/b.yaml": "_alias: a\n"})
    for c in (compose, jax_compose):
        with pytest.raises(ValueError, match="cycle"):
            c(config_dir=d, overrides=[])
