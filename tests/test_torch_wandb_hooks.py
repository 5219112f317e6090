"""The port trainer's wandb hooks, against a stub ``wandb`` module in
``sys.modules`` (wandb is not installed here and a real run needs the
network): the in-training demo's audio and the profiler trace as an
artifact, as the JAX trainer logs them; nothing without a run; a failed
upload is printed and training goes on."""
import os
import sys
import types

import numpy as np
import pytest

from aid_tpu_torch import setup as tsetup
from aid_tpu_torch.utils.config import compose
from tests.torch_threads import one_torch_thread  # noqa: F401

TINY = ["exp.audio_len=2048", "exp.batch=2", "exp.total_its=2", "network.cqt.num_octs=3",
        "network.cqt.bins_per_oct=8", "network.Ns=[8,16,16]", "network.num_dils=[1,1,1]",
        "network.attention_layers=[0,0,1,1]", "network.compute_dtype=float32",
        "logging.print_model_summary=False", "logging.save_model=False",
        "logging.heavy_log_interval=100", "exp.exp_name=stubbed"]


class _Run:
    def __init__(self, fail=False):
        self.logged, self.artifacts, self.fail = [], [], fail

    def log(self, data, step=None):
        if self.fail and any(k.startswith("demo/") for k in data):
            raise ConnectionError("wandb unreachable")
        self.logged.append((data, step))

    def log_artifact(self, art):
        if self.fail:
            raise ConnectionError("wandb unreachable")
        self.artifacts.append(art)

    def finish(self):
        pass


@pytest.fixture
def stub_wandb(monkeypatch):
    mod = types.ModuleType("wandb")
    mod.run = _Run()
    mod.init = lambda **kw: mod.run

    class Audio:
        def __init__(self, data, sample_rate):
            self.data, self.sample_rate = data, sample_rate

    class Artifact:
        def __init__(self, name, type):
            self.name, self.type, self.dirs = name, type, []

        def add_dir(self, d):
            self.dirs.append(d)

    mod.Audio, mod.Artifact = Audio, Artifact
    monkeypatch.setitem(sys.modules, "wandb", mod)
    return mod


class _Batches:
    def __iter__(self):
        return self

    def __next__(self):
        rng = np.random.default_rng(0)
        return (rng.standard_normal((2, 2048)) * 0.1).astype(np.float32), np.full(2, 22050)


class _Tester:
    def sample_unconditional_ema(self, ema):
        return np.full((2, 2048), 0.25, np.float32)


def _trainer(tmp_path, *extra):
    args = compose(overrides=TINY + [f"model_dir={tmp_path}", *extra])
    net = tsetup.setup_network(args, device="cpu", trainable=True)
    tr = tsetup.setup_trainer(args, dset=_Batches(), network=net,
                              diff_params=tsetup.setup_diff_parameters(args),
                              tester=_Tester())
    tr.init_state()
    return tr


def test_demo_audio_goes_to_the_run(stub_wandb, tmp_path):
    tr = _trainer(tmp_path, "exp.wandb.use=True")
    tr.it = 7
    tr.heavy_logging()
    (data, step), = [e for e in stub_wandb.run.logged if "demo/uncond_0" in e[0]]
    assert step == 7 and sorted(data) == ["demo/uncond_0", "demo/uncond_1"]
    clip = data["demo/uncond_1"]
    assert clip.sample_rate == 22050 and np.all(clip.data == 0.25)
    assert os.path.exists(tmp_path / "heavy_logging" / "it_7" / "uncond_1.wav")


def test_profile_trace_goes_to_the_run(stub_wandb, tmp_path, capsys):
    tr = _trainer(tmp_path, "exp.wandb.use=True", "logging.profiling.enabled=True",
                  "logging.profiling.start_it=0", "logging.profiling.num_its=1")
    assert tr.training_loop() == 2
    (art,) = stub_wandb.run.artifacts
    assert (art.name, art.type, art.dirs) == ("profile-stubbed", "profile", [tr.profile_dir])
    assert os.path.exists(os.path.join(tr.profile_dir, "trace_it1.json"))
    assert "uploaded as a wandb artifact" in capsys.readouterr().out


def test_failed_uploads_are_printed_not_raised(stub_wandb, tmp_path, capsys):
    stub_wandb.run = _Run(fail=True)
    tr = _trainer(tmp_path, "exp.wandb.use=True", "logging.profiling.enabled=True",
                  "logging.profiling.start_it=0", "logging.profiling.num_its=1")
    assert tr.training_loop() == 2
    tr.heavy_logging()
    out = capsys.readouterr().out
    assert "artifact upload skipped" in out and "demo audio not logged" in out
    assert tr._demo_failures == 0                       # the demo itself was written


def test_without_a_run_nothing_is_logged(stub_wandb, tmp_path):
    tr = _trainer(tmp_path, "logging.profiling.enabled=True", "logging.profiling.start_it=0",
                  "logging.profiling.num_its=1")
    assert tr.wandb._run is None
    tr.training_loop()
    tr.heavy_logging()
    tr._log_wandb_audio({"x": (np.zeros(4), 22050)}, 1)
    assert stub_wandb.run.logged == [] and stub_wandb.run.artifacts == []


def test_scalars_still_logged_when_uploads_fail(stub_wandb, tmp_path):
    stub_wandb.run = _Run(fail=True)
    tr = _trainer(tmp_path, "exp.wandb.use=True", "logging.log_interval=1")
    assert tr.training_loop() == 2
    assert [step for _, step in stub_wandb.run.logged] == [1, 2]
