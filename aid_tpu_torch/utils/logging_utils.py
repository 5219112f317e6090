"""What the trainer logs besides its printed lines: the loss-by-sigma curve
and an optional wandb run (the part of ``aid_tpu/utils/logging_utils.py``
that the training loop calls; the demo wavs and spectrograms wait for the
testers).

matplotlib and wandb are optional: without them a plot or a run is skipped
with one line, and training goes on.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


class LossBySigmaPlot:
    """The loss-vs-sigma binned curve, redrawn into one persistent figure:
    the plot runs every tenth log interval for the life of a run, and a new
    figure per call grew the host's memory in the JAX package's long runs."""

    def __init__(self):
        self._fig = None
        self._warned = False

    def __call__(self, bin_edges: Sequence[float], means: Sequence[float],
                 stds: Sequence[float], out_path: str) -> Optional[str]:
        if self._fig is None:
            try:
                from matplotlib.figure import Figure
            except ImportError:
                if not self._warned:
                    print("[logging] matplotlib is not installed: loss-by-sigma plot skipped",
                          flush=True)
                    self._warned = True
                return None
            self._fig = Figure(figsize=(7, 4))
        edges = np.asarray(bin_edges)
        centers = np.sqrt(edges[:-1] * edges[1:])
        fig = self._fig
        fig.clear()
        ax = fig.add_subplot(111)
        ax.errorbar(centers, np.asarray(means), yerr=np.asarray(stds), marker="o", ms=3,
                    lw=1, capsize=2)
        ax.set_xscale("log")
        ax.set_yscale("log")
        ax.set_xlabel("sigma")
        ax.set_ylabel("loss")
        fig.tight_layout()
        fig.savefig(out_path, dpi=90)
        return out_path


class WandbLogger:
    """Optional wandb sink, off unless ``exp.wandb.use`` is set; a no-op when
    wandb is not installed or cannot start."""

    def __init__(self, cfg, args_dict=None, run_name: str = ""):
        self._run = None
        if cfg is None or not bool(cfg.get("use", False)):
            return
        try:
            import wandb
            self._run = wandb.init(entity=cfg.get("entity") or None,
                                   project=cfg.get("project", "aid-tpu"),
                                   config=args_dict, name=run_name or None)
        except Exception as e:  # logging must never stop training
            print(f"[wandb] disabled: {e}", flush=True)

    def log(self, data: dict, step: Optional[int] = None):
        if self._run is not None:
            self._run.log(data, step=step)

    def finish(self):
        if self._run is not None:
            self._run.finish()
