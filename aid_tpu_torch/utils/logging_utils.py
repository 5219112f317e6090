"""What the trainer and the testers write besides their printed lines (port
of ``aid_tpu/utils/logging_utils.py``): wav files, spectrogram images,
sampler-trajectory filmstrips and animations, the loss-by-sigma curve and an
optional wandb run.

matplotlib, PIL and wandb are optional: without them a plot, an animation or
a run is skipped with one line, and the caller goes on.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from aid_tpu_torch.data import audio_io
from aid_tpu_torch.ops import stft as stft_ops

_missing_warned = set()


def _warn_missing(what: str) -> None:
    if what not in _missing_warned:
        print(f"[logging] {what} is not installed: its images are skipped", flush=True)
        _missing_warned.add(what)


def _figure(figsize):
    try:
        from matplotlib.figure import Figure
    except ImportError:
        _warn_missing("matplotlib")
        return None
    return Figure(figsize=figsize)


def write_audio_file(x, fs: int, name: str, path: str = ".", normalize: bool = True) -> str:
    """Save a mono 16-bit wav ``path/name.wav``, peak-normalised only when
    it would clip. Returns the file's path."""
    os.makedirs(path, exist_ok=True)
    fp = os.path.join(path, name if name.endswith(".wav") else name + ".wav")
    audio_io.write(fp, np.asarray(x, np.float32).reshape(-1), int(fs),
                   normalize_if_clipping=normalize)
    return fp


def _stft_mag_db(x: np.ndarray, n_fft: int = 1024, hop: int = 256) -> np.ndarray:
    """|STFT| in dB, [frames, F], computed on the host."""
    X = stft_ops.stft(torch.as_tensor(np.asarray(x, np.float32).reshape(-1)), n_fft, hop,
                      n_fft)
    return (20.0 * torch.log10(X.abs() + 1e-8)).T.numpy()


def plot_spectrogram_from_raw_audio(x, fs: int, out_path: str, n_fft: int = 1024,
                                    hop: int = 256, title: str = "") -> Optional[str]:
    """Log-magnitude STFT image of a signal, 80 dB below its peak."""
    fig = _figure((10, 4))
    if fig is None:
        return None
    S = _stft_mag_db(x, n_fft, hop)
    ax = fig.add_subplot(111)
    ax.imshow(S.T, origin="lower", aspect="auto",
              extent=[0, S.shape[0] * hop / fs, 0, fs / 2 / 1000.0],
              vmin=S.max() - 80, vmax=S.max(), cmap="magma")
    ax.set_xlabel("time [s]")
    ax.set_ylabel("freq [kHz]")
    if title:
        ax.set_title(title)
    fig.tight_layout()
    fig.savefig(out_path, dpi=90)
    return out_path


def _steps(xt_steps, max_frames: int):
    xt = np.asarray(xt_steps)
    if xt.ndim == 3:
        xt = xt[:, 0]
    steps = np.unique(np.linspace(0, xt.shape[0] - 1,
                                  min(max_frames, xt.shape[0])).astype(int))
    return xt, steps


def plot_diffusion_trajectory(xt_steps, fs: int, out_path: str, max_frames: int = 8,
                              n_fft: int = 1024, hop: int = 256) -> Optional[str]:
    """Spectrogram filmstrip of a sampler trajectory ([T, L] or [T, B, L],
    e.g. the rid Record's ``denoised``): up to ``max_frames`` steps."""
    xt, steps = _steps(xt_steps, max_frames)
    fig = _figure((3 * len(steps), 3))
    if fig is None:
        return None
    axes = fig.subplots(1, len(steps), sharey=True, squeeze=False)[0]
    for ax, s in zip(axes, steps):
        S = _stft_mag_db(xt[s], n_fft, hop)
        ax.imshow(S.T, origin="lower", aspect="auto", vmin=S.max() - 80, vmax=S.max(),
                  cmap="magma")
        ax.set_title(f"step {s}")
        ax.set_xticks([])
        ax.set_yticks([])
    fig.tight_layout()
    fig.savefig(out_path, dpi=90)
    return out_path


def animate_diffusion_trajectory(xt_steps, fs: int, out_path: str, max_frames: int = 24,
                                 n_fft: int = 1024, hop: int = 256,
                                 ms_per_frame: int = 120) -> Optional[str]:
    """Animated GIF of a trajectory's spectrograms, every frame on the same
    80 dB scale anchored at the last step's peak."""
    try:
        from PIL import Image
    except ImportError:
        _warn_missing("PIL")
        return None
    xt, steps = _steps(xt_steps, max_frames)
    vmax = float(_stft_mag_db(xt[steps[-1]], n_fft, hop).max())
    frames = []
    for s in steps:
        S = _stft_mag_db(xt[s], n_fft, hop)
        img = np.clip((S.T[::-1] - (vmax - 80.0)) / 80.0, 0.0, 1.0)
        frames.append(Image.fromarray((_magma(img) * 255).astype(np.uint8)))
    frames[0].save(out_path, save_all=True, append_images=frames[1:],
                   duration=ms_per_frame, loop=0)
    return out_path


def _magma(v: np.ndarray) -> np.ndarray:
    """v in [0, 1] -> RGB through matplotlib's magma (grey without it)."""
    try:
        import matplotlib
        return matplotlib.colormaps["magma"](v)[..., :3]
    except ImportError:
        return np.stack([v, v, v], axis=-1)


class LossBySigmaPlot:
    """The loss-vs-sigma binned curve, redrawn into one persistent figure:
    the plot runs every tenth log interval for the life of a run, and a new
    figure per call grew the host's memory in the JAX package's long runs."""

    def __init__(self):
        self._fig = None

    def __call__(self, bin_edges: Sequence[float], means: Sequence[float],
                 stds: Sequence[float], out_path: str) -> Optional[str]:
        if self._fig is None:
            self._fig = _figure((7, 4))
            if self._fig is None:
                return None
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
