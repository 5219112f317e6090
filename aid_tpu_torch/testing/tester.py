"""Evaluation harness (port of ``aid_tpu/testing/tester.py``): checkpoint
loading, mask preparation, one job per mode writing a dated tree of
original / degraded / reconstructed wavs, optional ``rid`` dumps, and the
``dodajob`` dispatch over the configured modes with objective metrics after
each mode that wrote a tree.

Modes: unconditional, inpainting, inpainting_mushra (alias
inpainting_fordamushra), inpainting_shortgaps, spectrogram_inpainting, bwe,
declipping, comp_sens, phase_retrieval, autoregressive.

Noise comes from one ``torch.Generator`` on the tester's device, seeded with
``exp.seed + 1``; every draw (sampler noise, compressive-sensing masks, the
seed of the random short-gap masks) is taken from it in call order.

Where the JAX package's tester differs: ``test_bwe`` feeds the sampler the
lowpassed observation, built by the same filter the sampler guides with,
and saves it as "degraded" (the JAX tester feeds the clean audio and saves
a firwin-filtered copy whatever the filter type).
"""
from __future__ import annotations

import copy
import datetime
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from aid_tpu_torch import setup as tsetup
from aid_tpu_torch.data import audio_io
from aid_tpu_torch.sampling import degradations as degr
from aid_tpu_torch.testing import metrics
from aid_tpu_torch.utils import checkpoint as ckpt
from aid_tpu_torch.utils import checkpoint_torch
from aid_tpu_torch.utils import logging_utils as logu


def _numpy(x: torch.Tensor) -> np.ndarray:
    return x.detach().float().cpu().numpy()


class Tester:
    def __init__(self, args=None, network=None, diff_params=None, test_set=None,
                 in_training: bool = False, device=None):
        """``network``: the denoiser on ``device`` (CUDA unless named). In
        training (``in_training``) the tester samples with its own frozen
        copy of the network with remat off, into which the trainer's EMA
        weights are loaded for each demo."""
        self.args = args
        self.t = args.tester
        dev = tsetup.resolve_device(device)
        net_dev = next(network.parameters()).device
        if net_dev.type != dev.type:
            raise ValueError(f"the network is on {net_dev}, the tester runs on {dev}")
        self.device = net_dev
        if in_training:
            network = copy.deepcopy(network)
            network.remat = False
            for p in network.parameters():
                p.grad = None
            network.requires_grad_(False).eval()
        self.network = network
        self.test_set = test_set
        self.rid = bool(self.t.get("rid", False))
        self.sampler = tsetup.setup_sampler(args, network=network, diff_params=diff_params,
                                            rid=self.rid)
        self.fs = int(args.exp.sample_rate)
        self.audio_len = int(args.exp.audio_len)
        self.batch_size = int(self.t.get("batch_size", 1))
        stamp = datetime.date.today().strftime("%Y-%m-%d")
        self.base_dir = os.path.join(str(args.model_dir), "test", stamp)
        self.gen = torch.Generator(device=self.device).manual_seed(
            int(args.exp.get("seed", 42)) + 1)
        self.seconds: Dict[str, float] = {}

    def _draw_seed(self) -> int:
        return int(torch.randint(0, 2 ** 62, (1,), generator=self.gen, device=self.device))

    # -------------------------------------------------------------- checkpoint

    def load_checkpoint(self, path: Optional[str] = None) -> bool:
        """Load EMA weights into the network: a ``.pt`` file (the reference
        layout, which the port's own ``{exp}-{it}.pt`` shares) or a JAX
        stream ``.ckpt`` directory. False when no path is given or
        configured; a missing or unfitting file raises."""
        path = path or str(self.t.get("checkpoint") or "")
        if not path or path == "None":
            return False
        if os.path.isdir(path):
            checkpoint_torch.load_into(self.network,
                                       checkpoint_torch.find_state_dict(ckpt.load(path)))
        else:
            checkpoint_torch.load_reference_checkpoint(path, self.network)
        return True

    def load_latest_checkpoint(self, model_dir: Optional[str] = None) -> bool:
        """The highest-iteration ``*-{it}.pt`` or stream ``*-{it}.ckpt`` in
        ``model_dir`` (``.pt`` first at equal iterations); False if none."""
        found = ckpt.list_checkpoints(model_dir or str(self.args.model_dir))
        return bool(found) and self.load_checkpoint(found[-1])

    # ------------------------------------------------------------------ masks

    def prepare_mask(self, mode: Optional[str] = None, seed: Optional[int] = None
                     ) -> np.ndarray:
        """[1, L] mask: one long gap (centred unless ``start_gap_idx``), or
        ``num_gaps`` short gaps at the configured starts or, without them,
        at random starts drawn from ``np.random.default_rng(seed or 0)``.
        Lengths and starts in ms."""
        inp = self.t.inpainting
        mode = mode or str(inp.get("mask_mode", "long"))
        mask = np.ones((1, self.audio_len), np.float32)
        if mode == "long":
            gap = int(float(inp.long.gap_length) / 1000.0 * self.fs)
            start = inp.long.get("start_gap_idx", None)
            s = ((self.audio_len - gap) // 2 if start in (None, "None")
                 else int(float(start) / 1000.0 * self.fs))
            mask[:, s:s + gap] = 0.0
        else:
            gap = int(float(inp.short.gap_length) / 1000.0 * self.fs)
            starts = inp.short.get("start_gap_idx", None)
            rng = np.random.default_rng(0 if seed is None else seed)
            for i in range(int(inp.short.num_gaps)):
                if starts in (None, "None"):
                    s = int(rng.integers(self.audio_len // 8, self.audio_len * 7 // 8 - gap))
                else:
                    s = int(float(starts[i]) / 1000.0 * self.fs)
                mask[:, s:s + gap] = 0.0
        return mask

    def prepare_spectral_mask(self) -> np.ndarray:
        """(F, frames) mask with a zeroed time-frequency box: the configured
        time length (ms) and start (centred when None) over the configured
        band (Hz)."""
        sp = self.t.spectrogram_inpainting
        n_fft, hop = int(sp.stft.n_fft), int(sp.stft.hop_length)
        n_frames = 1 + (self.audio_len + (n_fft - self.audio_len % n_fft)) // hop
        F = n_fft // 2 + 1
        mask = np.ones((F, n_frames), np.float32)
        t_len = int(float(sp.time_mask_length) / 1000.0 * self.fs / hop)
        t0 = sp.get("time_start_idx", None)
        t_start = ((n_frames - t_len) // 2 if t0 in (None, "None")
                   else int(float(t0) / 1000.0 * self.fs / hop))
        f_lo = int(float(sp.min_masked_freq) / (self.fs / 2) * (F - 1))
        f_hi = int(float(sp.max_masked_freq) / (self.fs / 2) * (F - 1))
        mask[f_lo:f_hi + 1, t_start:t_start + t_len] = 0.0
        return mask

    # ------------------------------------------------------------------ utils

    def _resample_to_model(self, audio: np.ndarray, fs: int) -> np.ndarray:
        if fs != self.fs:
            audio = audio_io.resample_host(audio, fs, self.fs)
        if audio.shape[-1] < self.audio_len:
            audio = np.pad(audio, (0, self.audio_len - audio.shape[-1]))
        return audio[: self.audio_len]

    def _tensor(self, x: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.array(x, np.float32), device=self.device)

    def _save_triplet(self, mode: str, name: str, original, degraded, reconstructed) -> None:
        for sub, x in (("original", original), ("degraded", degraded),
                       ("reconstructed", reconstructed)):
            logu.write_audio_file(x, self.fs, name, os.path.join(self.base_dir, mode, sub))

    def _maybe_dump_rid(self, mode: str, name: str, rec, index: int = 0) -> None:
        """This file's row of the Record: one ``{name}_{field}.npy`` [T, L]
        per field, and the denoised trajectory as a filmstrip and a GIF."""
        if not self.rid or rec is None:
            return
        d = os.path.join(self.base_dir, mode, "rid")
        os.makedirs(d, exist_ok=True)
        for field in rec._fields:
            np.save(os.path.join(d, f"{name}_{field}.npy"),
                    _numpy(getattr(rec, field)[:, index]))
        traj = _numpy(rec.denoised[:, index])
        logu.plot_diffusion_trajectory(traj, self.fs, os.path.join(d, f"{name}_trajectory.png"))
        logu.animate_diffusion_trajectory(traj, self.fs,
                                          os.path.join(d, f"{name}_trajectory.gif"))

    def _split(self, out):
        return out if self.rid else (out, None)

    def _iter_test_batches(self):
        """(audio [B, L] at the model's rate, names) batches of the test set."""
        buf_x, buf_n = [], []
        for item in self.test_set:
            audio, fs, name = item[0], item[-2], item[-1]
            buf_x.append(self._resample_to_model(np.asarray(audio, np.float32), int(fs)))
            buf_n.append(os.path.splitext(str(name))[0])
            if len(buf_x) == self.batch_size:
                yield np.stack(buf_x), buf_n
                buf_x, buf_n = [], []
        if buf_x:
            yield np.stack(buf_x), buf_n

    def _per_file(self, mode: str, names, audio, degraded, x, rec) -> List[str]:
        for i, name in enumerate(names):
            self._save_triplet(mode, name, audio[i], degraded[i], x[i])
            self._maybe_dump_rid(mode, name, rec, index=i)
        return list(names)

    # ------------------------------------------------------------------ modes

    def sample_unconditional(self) -> np.ndarray:
        n = int(self.t.unconditional.num_samples)
        L = int(self.t.unconditional.get("audio_len", self.audio_len))
        x, _ = self._split(self.sampler.predict_unconditional((n, L), generator=self.gen))
        return _numpy(x)

    def sample_unconditional_ema(self, ema: Dict[str, torch.Tensor]) -> np.ndarray:
        """The trainer's demo: load ``ema`` (parameter name -> tensor) into
        the tester's network (in training, its own copy) and sample
        unconditionally. The next demo loads other weights, which drops the
        program built over these, so it is released now: training does not
        carry its graph pool between demos."""
        with torch.no_grad():
            for n, p in self.network.named_parameters():
                p.copy_(ema[n])
        try:
            return self.sample_unconditional()
        finally:
            self.sampler.release_programs()

    def test_unconditional(self) -> None:
        d = os.path.join(self.base_dir, "unconditional")
        for i, xi in enumerate(self.sample_unconditional()):
            fp = logu.write_audio_file(xi, self.fs, f"unconditional_{i}", d)
            logu.plot_spectrogram_from_raw_audio(xi, self.fs, fp + ".png")

    def test_inpainting_mushra(self) -> List[str]:
        """Centred long gaps of ``inpainting.mushra_gap_lengths`` ms (the
        reference's MUSHRA set: 371, 743, 1486 and 2962 ms), one mode tree
        ``inpainting_mushra_{g}ms`` each."""
        written = []
        for g in self.t.inpainting.get("mushra_gap_lengths", [371, 743, 1486, 2962]):
            mask = np.ones((1, self.audio_len), np.float32)
            gap = int(float(g) / 1000.0 * self.fs)
            s = (self.audio_len - gap) // 2
            mask[:, s:s + gap] = 0.0
            written += self.test_inpainting(mode=f"inpainting_mushra_{g}ms", mask_np=mask)
        return written

    def test_inpainting(self, mode: str = "inpainting",
                        mask_np: Optional[np.ndarray] = None) -> List[str]:
        """Long/short-gap inpainting of every test file."""
        if mask_np is None:
            mask_np = self.prepare_mask()
        written = []
        for audio, names in self._iter_test_batches():
            mask = self._tensor(np.broadcast_to(mask_np, audio.shape))
            y_masked = self._tensor(audio) * mask
            x, rec = self._split(self.sampler.predict_inpainting(y_masked, mask,
                                                                 generator=self.gen))
            written += self._per_file(mode, names, audio, _numpy(y_masked), _numpy(x), rec)
        return written

    def test_inpainting_short_gaps(self) -> List[str]:
        """Short-gap inpainting, file by file, with the test set's masks
        ((audio, mask, fs, filename) items) or, for (audio, fs, filename)
        items, random short gaps from ``prepare_mask``."""
        written = []
        for item in self.test_set:
            if len(item) == 4:
                audio, mask_np, fs, name = item
            else:
                audio, fs, name = item[0], item[-2], item[-1]
                mask_np = self.prepare_mask("short", self._draw_seed())[0]
            audio = self._resample_to_model(np.asarray(audio, np.float32), int(fs))[None]
            mask = self._tensor(np.asarray(mask_np, np.float32).reshape(-1)[: self.audio_len])
            y_masked = self._tensor(audio) * mask[None]
            x, rec = self._split(self.sampler.predict_inpainting(y_masked, mask[None],
                                                                 generator=self.gen))
            name = os.path.splitext(str(name))[0]
            written += self._per_file("inpainting_shortgaps", [name], audio, _numpy(y_masked),
                                      _numpy(x), rec)
        return written

    def test_spectrogram_inpainting(self) -> List[str]:
        """Inpainting of the configured STFT box in every test file."""
        mask_FT = self._tensor(self.prepare_spectral_mask())
        apply_mask = degr.spectral_mask(mask_FT, self.t.spectrogram_inpainting.stft)
        written = []
        for audio, names in self._iter_test_batches():
            with torch.no_grad():
                y_masked = apply_mask(self._tensor(audio))
            x, rec = self._split(self.sampler.predict_spectrogram_inpainting(
                y_masked, mask_FT, generator=self.gen))
            written += self._per_file("spectrogram_inpainting", names, audio,
                                      _numpy(y_masked), _numpy(x), rec)
        return written

    def interactive_spectrogram_inpainting(self, seg, fs, mask_FT) -> np.ndarray:
        """Inpaint one segment under a user-painted (F, frames) STFT mask."""
        audio = self._resample_to_model(np.asarray(seg, np.float32), int(fs))
        mask = self._tensor(mask_FT)
        with torch.no_grad():
            y_masked = degr.spectral_mask(mask, self.t.spectrogram_inpainting.stft)(
                self._tensor(audio)[None])
        x, _ = self._split(self.sampler.predict_spectrogram_inpainting(y_masked, mask,
                                                                       generator=self.gen))
        return _numpy(x)[0]

    def test_bwe(self) -> List[str]:
        """Bandwidth extension: the observation is the configured lowpass of
        the audio, which is also saved as "degraded"."""
        f = self.t.bandwidth_extension.filter
        kind, fc, order = str(f.get("type", "firwin")), float(f.get("fc", 1000)), int(
            f.get("order", 200))
        lpf = degr.bwe_lowpass(kind, order, fc, self.fs)
        written = []
        for audio, names in self._iter_test_batches():
            with torch.no_grad():
                y_lp = lpf(self._tensor(audio))
            x, rec = self._split(self.sampler.predict_bwe(y_lp, fc, self.fs, filter_type=kind,
                                                          order=order, generator=self.gen))
            written += self._per_file("bwe", names, audio, _numpy(y_lp), _numpy(x), rec)
        return written

    def test_declipping(self) -> List[str]:
        """Declipping of each batch clipped to ``declipping.SDR`` dB."""
        sdr = float(self.t.declipping.SDR)
        written = []
        for audio, names in self._iter_test_batches():
            y = self._tensor(audio)
            cv = degr.clip_value_from_sdr(y, sdr)
            y_clip = degr.hard_clip(cv)(y)
            x, rec = self._split(self.sampler.predict_declipping(y_clip, cv, generator=self.gen))
            written += self._per_file("declipping", names, audio, _numpy(y_clip), _numpy(x),
                                      rec)
        return written

    def test_comp_sens(self) -> List[str]:
        """Compressive sensing from ``comp_sens.percentage``% random samples."""
        pct = float(self.t.comp_sens.percentage)
        written = []
        for audio, names in self._iter_test_batches():
            mask = degr.compsens_mask(audio.shape, pct, generator=self.gen, device=self.device)
            y = self._tensor(audio) * mask
            x, rec = self._split(self.sampler.predict_compsens(y, mask, generator=self.gen))
            written += self._per_file("comp_sens", names, audio, _numpy(y), _numpy(x), rec)
        return written

    def test_phase_retrieval(self) -> List[str]:
        """Phase retrieval from the STFT magnitude; writes
        ``{name}_original`` and ``{name}_reconstructed`` wavs."""
        mag = degr.stft_magnitude(self.t.spectrogram_inpainting.stft)
        d = os.path.join(self.base_dir, "phase_retrieval")
        written = []
        for audio, names in self._iter_test_batches():
            with torch.no_grad():
                y_mag = mag(self._tensor(audio))
            x, _ = self._split(self.sampler.predict_phase_retrieval(
                y_mag, (audio.shape[0], self.audio_len), generator=self.gen))
            x = _numpy(x)
            for i, name in enumerate(names):
                logu.write_audio_file(audio[i], self.fs, name + "_original", d)
                logu.write_audio_file(x[i], self.fs, name + "_reconstructed", d)
                written.append(name)
        return written

    def test_autoregressive(self) -> str:
        """``autoregressive.num_samples`` chained segments in one wav."""
        n = int(self.t.autoregressive.get("num_samples", 4))
        ov = float(self.t.autoregressive.get("overlap", 0.25))
        x = _numpy(self.sampler.predict_autoregressive(n, ov, generator=self.gen))
        return logu.write_audio_file(x[0], self.fs, "autoregressive",
                                     os.path.join(self.base_dir, "autoregressive"))

    # ---------------------------------------------------------------- dispatch

    def dodajob(self) -> Dict[str, Any]:
        """Run every mode of ``tester.modes`` in order; after each, score its
        tree (``metrics.json``) where it wrote one. Each mode's host seconds
        go to ``self.seconds``."""
        jobs = {"unconditional": self.test_unconditional,
                "inpainting": self.test_inpainting,
                "inpainting_mushra": self.test_inpainting_mushra,
                "inpainting_fordamushra": self.test_inpainting_mushra,
                "inpainting_shortgaps": self.test_inpainting_short_gaps,
                "spectrogram_inpainting": self.test_spectrogram_inpainting,
                "bwe": self.test_bwe,
                "declipping": self.test_declipping,
                "comp_sens": self.test_comp_sens,
                "phase_retrieval": self.test_phase_retrieval,
                "autoregressive": self.test_autoregressive}
        results: Dict[str, Any] = {}
        for mode in map(str, self.t.get("modes", [])):
            if mode not in jobs:
                print(f"[tester] unknown mode {mode!r}, skipped", flush=True)
                continue
            t0 = time.time()
            results[mode] = jobs[mode]()
            self.seconds[mode] = time.time() - t0
            print(f"[tester] {mode}: {self.seconds[mode]:.1f} s", flush=True)
            mode_dir = os.path.join(self.base_dir, mode)
            if os.path.isdir(os.path.join(mode_dir, "reconstructed")):
                scores = metrics.score_directory(mode_dir)
                if "__mean__" in scores:
                    print(f"[tester] {mode} metrics: {scores['__mean__']}", flush=True)
        return results
