"""The port's data layer (``aid_tpu_torch/data``) against the JAX package's:
WAV I/O, host resampling, the MAESTRO loaders and batching on a generated
MAESTRO-layout tree (CSV + WAVs at 44.1 and 48 kHz), the LibriSpeech loaders
on a generated FLAC corpus. For the same seed and files both packages yield
the same segments."""
import csv
import itertools

import numpy as np
import pytest
import scipy.signal
import torch.distributed

from aid_tpu.data import audio_io as jaudio
from aid_tpu.data import loader as jloader
from aid_tpu.data import maestro as jmaestro
from aid_tpu.utils.config import compose as jcompose
from aid_tpu_torch import setup as tsetup
from aid_tpu_torch.data import audio_io, loader, maestro
from aid_tpu_torch.utils.config import compose
from tests.torch_native import jax_native


@pytest.fixture(scope="module", autouse=True)
def jax_native_loaded():
    """The JAX package's native library (libsoxr, its WAV and FLAC
    readers) loaded before any test compares the two packages."""
    assert jax_native() is not None


@pytest.fixture(scope="module")
def wav_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("maestro_torch")
    rows = []
    rng = np.random.default_rng(0)
    for year, split in ((2015, "train"), (2017, "train"), (2009, "test")):
        (root / str(year)).mkdir()
        for j, fs in enumerate((44100, 48000)):
            rel = f"{year}/file_{j}.wav"
            n = 12000 + 1000 * j + 100 * (year % 10)
            audio_io.write(str(root / rel), rng.standard_normal(n) * 0.2, fs)
            rows.append({"year": year, "split": split, "audio_filename": rel})
    with open(root / "maestro-v3.0.0.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["year", "split", "audio_filename"])
        w.writeheader()
        w.writerows(rows)
    return str(root)


OVERRIDES = ["dset.years=[2015,2017]", "dset.load_len=4096", "dset.segments_per_file=3",
             "exp.audio_len=2000", "exp.resample_factor=2", "exp.seed=7",
             "dset.test.num_samples=2"]


def _args(root, *extra):
    return compose(overrides=[f"dset.path={root}", *OVERRIDES, *extra])


def _jargs(root, *extra):
    return jcompose(overrides=[f"dset.path={root}", *OVERRIDES, *extra])


def test_wav_roundtrip_and_segments(tmp_path):
    """16-bit WAV written by the port reads back within two quantisation
    steps (scaled by 32767 and truncated, read back over 32768), a segment
    read equals the slice of the whole, and the JAX package reads the same
    samples and header."""
    x = (np.sin(np.linspace(0, 100, 5000)) * 0.7).astype(np.float32)
    p = str(tmp_path / "a.wav")
    audio_io.write(p, x, 16000)
    assert audio_io.info(p) == (5000, 16000, 1) == tuple(jaudio.info(p))
    y, fs = audio_io.read(p)
    assert fs == 16000
    np.testing.assert_allclose(y, x, atol=2.0 / 32767)
    seg, _ = audio_io.read(p, 1000, 256)
    np.testing.assert_array_equal(seg, y[1000:1256])
    np.testing.assert_array_equal(jaudio.read(p, 1000, 256)[0], seg)
    # clipping input is peak-normalised before writing
    audio_io.write(p, 2 * x, 16000)
    np.testing.assert_allclose(audio_io.read(p)[0], x / 0.7 * (0.7 / np.abs(x).max()),
                               atol=2.0 / 32767)


def test_resample_host_is_resample_poly(monkeypatch):
    """With the native library (libsoxr) the port resamples as the JAX
    package does, sample for sample; without it, both take
    ``resample_poly``."""
    x = np.random.default_rng(1).standard_normal(4800).astype(np.float32)
    np.testing.assert_array_equal(audio_io.resample_host(x, 48000, 22050),
                                  jaudio.resample_host(x, 48000, 22050))
    np.testing.assert_array_equal(audio_io.resample_host(x, 22050, 22050), x)
    monkeypatch.setattr(audio_io, "_native", lambda: None)
    monkeypatch.setattr(jaudio, "_native", lambda: None)
    np.testing.assert_array_equal(audio_io.resample_host(x, 48000, 22050),
                                  scipy.signal.resample_poly(x, 147, 320).astype(np.float32))
    np.testing.assert_array_equal(audio_io.resample_host(x, 48000, 22050),
                                  jaudio.resample_host(x, 48000, 22050))


def test_maestro_fs_segments_match_jax(wav_tree):
    """Same seed, same files: the port yields the JAX loader's segments
    (file draws, segment starts and the native rate of each)."""
    ours = maestro.MaestroDatasetFs(_args(wav_tree))
    ref = jmaestro.MaestroDatasetFs(_jargs(wav_tree))
    assert ours.files == ref.files and len(ours.files) == 4
    rates = set()
    for (x, fs), (xr, fsr) in itertools.islice(zip(iter(ours), iter(ref)), 13):
        assert fs == fsr and x.shape == (4096,)
        np.testing.assert_array_equal(x, xr)
        rates.add(fs)
    assert rates == {44100, 48000}


def test_batched_matches_jax(wav_tree):
    ours = loader.batched(iter(maestro.MaestroDatasetFs(_args(wav_tree))), 3)
    ref = jloader.batched(iter(jmaestro.MaestroDatasetFs(_jargs(wav_tree))), 3)
    for _ in range(3):
        (a, f), (ar, fr) = next(ours), next(ref)
        assert a.shape == (3, 4096) and a.dtype == np.float32
        np.testing.assert_array_equal(a, ar)
        np.testing.assert_array_equal(f, fr)
    # shorter segments are zero-padded to the longest
    b, fs = next(loader.batched(iter([(np.ones(3), 1), (np.ones(5), 2)]), 2))
    np.testing.assert_array_equal(b, [[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]])


def test_fixed_rate_and_test_chunks(wav_tree):
    """MaestroDataset yields the JAX class's segments, resampled on the host
    to the model rate (44.1 and 48 kHz files, libsoxr in both) and cut or
    zero-padded to its length; the test chunks are the JAX class's (same
    files, offsets, lengths)."""
    ours = maestro.MaestroDataset(_args(wav_tree))
    ref = jmaestro.MaestroDataset(_jargs(wav_tree))
    natives = {fs for _, fs in itertools.islice(iter(maestro.MaestroDatasetFs(_args(wav_tree))), 8)}
    assert natives == {44100, 48000}
    for (y, fs), (yr, fsr) in itertools.islice(zip(iter(ours), iter(ref)), 8):
        assert fs == fsr == 22050 and y.shape == (2000,)
        np.testing.assert_array_equal(y, yr)
    ours = list(tsetup.setup_dataset_test(_args(wav_tree)))
    ref = list(jmaestro.MaestroDatasetTestChunks(_jargs(wav_tree)))
    assert len(ours) == len(ref) == 2
    for (x, fs, name), (xr, fsr, namer) in zip(ours, ref):
        assert (fs, name) == (fsr, namer) and x.shape == (4000,)
        np.testing.assert_array_equal(x, xr)


def test_overfit_and_unusable_corpus(wav_tree):
    it = iter(maestro.MaestroDatasetFs(_args(wav_tree, "dset.overfit=True")))
    a, b = next(it), next(it)
    np.testing.assert_array_equal(a[0], b[0])
    with pytest.raises(RuntimeError, match="shorter than load_len"):
        next(iter(maestro.MaestroDatasetFs(_args(wav_tree, "dset.load_len=10000000"))))


def test_process_seed_uses_the_rank_only_when_distributed(monkeypatch):
    assert maestro._process_seed(42) == 42
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: 2)
    assert maestro._process_seed(42) == 42 + 2 * 1000003


def test_prefetcher_hands_on_errors():
    def gen():
        yield 1
        raise KeyError("boom")

    p = loader.Prefetcher(gen(), depth=2)
    assert next(p) == 1
    with pytest.raises(KeyError):
        next(p)


def test_multiprocess_loader_matches_its_worker_stream(wav_tree):
    """One decode worker yields exactly the batches of the dataset seeded
    as that worker (seed + 7919); a worker's failure reaches the trainer."""
    args = _args(wav_tree)
    mp = loader.MultiProcessLoader(args, str(args.dset.callable), batch_size=2,
                                   num_workers=1)
    try:
        ref = loader.batched(iter(maestro.MaestroDatasetFs(
            _args(wav_tree, "exp.seed=7926"))), 2)
        for _ in range(3):
            (a, f), (ar, fr) = next(mp), next(ref)
            np.testing.assert_array_equal(a, ar)
            np.testing.assert_array_equal(f, fr)
    finally:
        mp.close()
    bad = _args(wav_tree, "dset.load_len=10000000")
    mp = loader.MultiProcessLoader(bad, str(bad.dset.callable), batch_size=1, num_workers=1)
    try:
        with pytest.raises(RuntimeError, match="data worker failed"):
            next(mp)
    finally:
        mp.close()


def test_audio_folder_sets_match_jax(wav_tree):
    """The MusicNet-path loaders over the tree's WAVs: the infinite train
    iterator yields the JAX package's segments for the same seed, and the
    test set the same (audio, fs, filename) items."""
    from aid_tpu.data import audiofolder as jfolder
    from aid_tpu_torch.data import audiofolder
    ov = ["dset=musicnet", f"dset.path={wav_tree}", f"dset.test.path={wav_tree}",
          "dset.test.num_samples=3", "exp.audio_len=3000", "exp.resample_factor=2", "exp.seed=7"]
    pairs = zip(audiofolder.AudioFolderDataset(compose(overrides=ov)),
                jfolder.AudioFolderDataset(jcompose(overrides=ov)))
    for (x, fs), (xj, fsj) in itertools.islice(pairs, 6):
        assert fs == fsj and x.shape == (6000,)
        np.testing.assert_array_equal(x, xj)
    got = list(audiofolder.AudioFolderDatasetTest(compose(overrides=ov)))
    ref = list(jfolder.AudioFolderDatasetTest(jcompose(overrides=ov)))
    assert [(fs, n) for _, fs, n in got] == [(fs, n) for _, fs, n in ref] and len(got) == 3
    for (x, _, _), (xj, _, _) in zip(got, ref):
        np.testing.assert_array_equal(x, xj)


def test_masked_test_set_matches_jax(wav_tree, tmp_path):
    """The short-gaps test set pairs each WAV with the mask of its stem, a
    .npy or a .mat, padded with ones or cut to the segment, as the JAX
    package's does."""
    import scipy.io
    from aid_tpu.data import masked as jmasked
    from aid_tpu_torch.data import masked
    m0 = np.ones(5000, bool)
    m0[100:300] = False
    np.save(str(tmp_path / "file_0.npy"), m0)
    m1 = np.ones(9000)
    m1[2000:2100] = 0.0
    scipy.io.savemat(str(tmp_path / "file_1.mat"), {"mask": m1[None]})
    ov = ["dset=inpainting_mask_dataset", f"dset.test.path={wav_tree}",
          f"dset.test.mask_path={tmp_path}", "dset.test.num_samples=4", "exp.audio_len=3000",
          "exp.resample_factor=2"]
    got = list(masked.MaskedAudioDatasetTest(compose(overrides=ov)))
    ref = list(jmasked.MaskedAudioDatasetTest(jcompose(overrides=ov)))
    assert len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        assert g[2:] == r[2:]
        np.testing.assert_array_equal(g[0], r[0])
        np.testing.assert_array_equal(g[1], r[1])
        assert g[1].shape == (6000,) and g[1].dtype == np.float32
    assert got[0][1][100:300].sum() == 0 and got[0][1][5000:].min() == 1.0
    (tmp_path / "file_0.npy").unlink()
    with pytest.raises(FileNotFoundError, match="file_0"):
        list(masked.MaskedAudioDatasetTest(compose(overrides=ov)))


def _flac_corpus(root, rng, lengths, fs=16000):
    """LibriSpeech layout: speaker/chapter/utterance.flac, 16-bit mono."""
    from tests import flac_fixture as ff
    for i, n in enumerate(lengths):
        sub = root / f"spk{i}" / "chap0"
        sub.mkdir(parents=True)
        x = np.clip(rng.standard_normal(n) * 9000, -32768, 32767).astype(np.int64)
        ff.encode(str(sub / f"utt{i}.flac"), [x], fs, kind="fixed", order=2, blocksize=1000)
    return str(root)


def _libri(root, *extra):
    ov = ["dset=librispeech", f"dset.path={root}", f"dset.test.path={root}",
          "exp=librispeech16k_8s", "exp.audio_len=4096", "exp.seed=11", *extra]
    return compose(overrides=ov), jcompose(overrides=ov)


@pytest.mark.parametrize("overfit", [False, True])
def test_librispeech_train_matches_jax(tmp_path, rng, overfit):
    """Random FLAC segments, short utterances pad-wrapped (tiled): the JAX
    loader's segments for the same seed."""
    from aid_tpu.data import librispeech as jlibri
    from aid_tpu_torch.data import librispeech
    root = _flac_corpus(tmp_path / "libri", rng, [9000, 3000, 6000])
    ta, ja = _libri(root, f"dset.overfit={overfit}")
    ours, ref = librispeech.LibrispeechTrain(ta), jlibri.LibrispeechTrain(ja)
    assert ours.files == ref.files and len(ours.files) == 3
    for (x, fs), (xr, fsr) in itertools.islice(zip(iter(ours), iter(ref)), 10):
        assert fs == fsr == 16000 and x.shape == (4096,) and x.dtype == np.float32
        np.testing.assert_array_equal(x, xr)


def test_librispeech_test_matches_jax(tmp_path, rng):
    """The first num_samples files, zero-padded to the segment length."""
    from aid_tpu.data import librispeech as jlibri
    from aid_tpu_torch.data import librispeech
    root = _flac_corpus(tmp_path / "libri", rng, [3000, 9000, 5000])
    ta, ja = _libri(root, "dset.test.num_samples=2")
    got = list(librispeech.LibrispeechTest(ta))
    ref = list(jlibri.LibrispeechTest(ja))
    assert len(got) == len(ref) == len(librispeech.LibrispeechTest(ta)) == 2
    for (x, fs, name), (xr, fsr, namer) in zip(got, ref):
        assert (fs, name) == (fsr, namer) and name.endswith(".flac") and x.shape == (4096,)
        np.testing.assert_array_equal(x, xr)
    assert np.all(got[0][0][3000:] == 0)


def test_librispeech_train_aborts_on_an_unreadable_corpus(tmp_path):
    from aid_tpu_torch.data import librispeech
    root = tmp_path / "bad"
    root.mkdir()
    for i in range(2):
        (root / f"garbage{i}.flac").write_bytes(b"this is not flac data")
    ds = librispeech.LibrispeechTrain(_libri(str(root))[0])
    ds.MAX_CONSECUTIVE_FAILURES = 5
    with pytest.raises(RuntimeError, match="5 consecutive decode failures"):
        next(iter(ds))
    with pytest.raises(FileNotFoundError):
        librispeech.LibrispeechTest(_libri(str(tmp_path / "empty"))[0])
