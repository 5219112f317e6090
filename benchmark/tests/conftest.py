"""The program's trace registry as the harness's readers of it see it in a
traced run: a fixed ``aid_tpu_torch.utils.trace.snapshot()`` holding spans
of both families and the phase marks of a body graph and a step graph (the
CPU records no marks), so that a reader given a context without its own
``trace`` has something to read."""
import pytest

SNAPSHOT = {
    "spans": {"serve.request": {"count": 1, "total_ms": 13000.0, "recent": [[0.0, 13000.0]]},
              "serve.device": {"count": 1, "total_ms": 12980.0, "recent": [[5.0, 12985.0]]},
              "train.step": {"count": 1, "total_ms": 630.0, "recent": [[0.0, 630.0]]},
              "train.replay": {"count": 1, "total_ms": 1.0, "recent": [[6.0, 7.0]]}},
    "marks": [{"graph": "heun.body", "replays": 34, "last": 0,
               "marks": [["heun.denoise", 41.0], ["heun.denoise", 41.0], ["heun.step", 381.0]]},
              {"graph": "train.step", "replays": 5, "last": 1,
               "marks": [["train.forward", 150.0], ["train.backward", 400.0],
                         ["train.update", 70.0]]}]}


@pytest.fixture(autouse=True)
def program_trace(monkeypatch):
    from aid_tpu_torch.utils import trace
    monkeypatch.setattr(trace, "snapshot", lambda: SNAPSHOT)
    return SNAPSHOT
