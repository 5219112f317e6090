"""Generate a MAESTRO-layout synthetic piano corpus through the PyTorch
port's audio writer (the stand-in for MAESTRO v3 where the real corpus is
not at hand).

Generated piano-like music with structure to learn: chord progressions in a
random key, 6-harmonic notes with exponential decays (piano-ish onsets), an
occasional melody line, bass notes, and an RMS matched to the config's
sigma_data=0.063. The layout is what the loaders read
(``aid_tpu_torch/data/maestro.py``): year directories and
``maestro-v3.0.0.csv`` with year/split/audio_filename columns; train years
2015/2017/2018, test 2009. The same seed gives the same samples as the JAX
package's ``scripts/make_synth_corpus.py``; only the writer differs
(``aid_tpu_torch.data.audio_io``).

Usage: python scripts/make_synth_corpus_torch.py <root> [n_train] [n_test] [secs]
"""
import csv
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

FS = 44100
# C major / A minor pitch set over 3 octaves (MIDI 48..83 naturals)
SCALE = [48, 50, 52, 53, 55, 57, 59]
TRIADS = [(0, 2, 4), (1, 3, 5), (2, 4, 6), (3, 5, 0), (4, 6, 1), (5, 0, 2)]


def midi_hz(m):
    return 440.0 * 2.0 ** ((m - 69) / 12.0)


def _note(t0, midi, dur, vel, t, out):
    """Add a decaying 6-harmonic tone starting at t0 (piano-ish envelope)."""
    i0 = int(t0 * FS)
    i1 = min(int((t0 + dur) * FS), t.size)
    if i1 <= i0:
        return
    tt = t[: i1 - i0]
    f0 = midi_hz(midi)
    env = vel * np.exp(-tt * (2.5 + 6.0 * f0 / 2000.0))
    seg = np.zeros_like(tt)
    for k in range(1, 7):
        if k * f0 > FS / 2 * 0.9:
            break
        seg += (env / k ** 1.5) * np.sin(2 * np.pi * k * f0 * tt + 0.7 * k)
    out[i0:i1] += seg


def make_file(rng: np.random.Generator, secs: float) -> np.ndarray:
    n = int(secs * FS)
    t = np.arange(n) / FS
    out = np.zeros(n, np.float64)
    key = int(rng.integers(-5, 7))           # transpose the whole piece
    pos = 0.0
    while pos < secs - 0.5:
        deg = TRIADS[int(rng.integers(0, len(TRIADS)))]
        dur = float(rng.uniform(0.6, 2.0))
        # block chord (mid register) + bass note one octave down
        for d in deg:
            _note(pos + rng.uniform(0, 0.02), SCALE[d] + 12 + key, dur,
                  rng.uniform(0.4, 0.9), t, out)
        _note(pos, SCALE[deg[0]] - 12 + key, dur, rng.uniform(0.5, 1.0), t, out)
        # melody: 1-4 short notes from the scale on top
        mpos = pos
        for _ in range(int(rng.integers(1, 5))):
            mdur = float(rng.uniform(0.15, 0.5))
            if mpos + mdur > pos + dur:
                break
            _note(mpos, SCALE[int(rng.integers(0, 7))] + 24 + key, mdur,
                  rng.uniform(0.3, 0.8), t, out)
            mpos += mdur
        pos += dur
    rms = float(np.sqrt(np.mean(out ** 2))) + 1e-9
    return (out * (0.063 / rms)).astype(np.float32)


def write_corpus(root: str, n_train: int = 48, n_test: int = 4, secs: float = 240.0,
                 seed: int = 0) -> list:
    """Write the corpus under ``root``; returns the CSV rows."""
    from aid_tpu_torch.data import audio_io

    rng = np.random.default_rng(seed)
    rows = []
    train_years = [2015, 2017, 2018]
    for j in range(n_train):
        year = train_years[j % len(train_years)]
        rel = f"{year}/train_{j:03d}.wav"
        os.makedirs(os.path.join(root, str(year)), exist_ok=True)
        audio_io.write(os.path.join(root, rel), make_file(rng, secs), FS)
        rows.append({"year": year, "split": "train", "audio_filename": rel})
        print(f"wrote {rel}", flush=True)
    for j in range(n_test):
        rel = f"2009/test_{j:03d}.wav"
        os.makedirs(os.path.join(root, "2009"), exist_ok=True)
        audio_io.write(os.path.join(root, rel), make_file(rng, secs), FS)
        rows.append({"year": 2009, "split": "test", "audio_filename": rel})
        print(f"wrote {rel}", flush=True)
    with open(os.path.join(root, "maestro-v3.0.0.csv"), "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["year", "split", "audio_filename"])
        w.writeheader()
        w.writerows(rows)
    print(f"corpus at {root}: {n_train} train + {n_test} test x {secs:.0f}s", flush=True)
    return rows


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    write_corpus(argv[0],
                 int(argv[1]) if len(argv) > 1 else 48,
                 int(argv[2]) if len(argv) > 2 else 4,
                 float(argv[3]) if len(argv) > 3 else 240.0)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
