"""The port's native audio I/O (``aid_tpu_torch/data/audio_io.py`` over its
own copies of ``audioio.cpp`` and ``flac.cpp``) against the JAX package's.

With both native libraries loaded: libsoxr resampling equal sample for
sample; WAV and FLAC ``info`` and ``read`` equal on fixtures written by
``tests/flac_fixture.py`` (every subframe type, Rice partitions with escape
codes, wasted bits, the four stereo modes, segment reads, an unknown stream
length), corrupt files raising in both; 16-bit writes byte for byte. With the
port's library forced off: ``resample_poly``, the Python WAV reader, FLAC
raising. A source tree that does not compile warns with the compiler's output.
"""
import wave

import numpy as np
import pytest
import scipy.signal

from aid_tpu.data import audio_io as jaudio
from aid_tpu_torch.data import audio_io
from tests import flac_fixture as ff
from tests.torch_native import jax_native

RATES = [(48000, 22050), (44100, 22050), (22050, 44100), (16000, 44100)]


@pytest.fixture
def both_native():
    """Both packages' native libraries loaded, the FLAC caches empty."""
    assert audio_io._native() is not None, audio_io.native_status()
    assert jax_native() is not None and hasattr(jaudio._native(), "aio_flac_info")
    audio_io._FLAC_CACHE.clear()
    jaudio._FLAC_CACHE.clear()
    yield
    audio_io._FLAC_CACHE.clear()
    jaudio._FLAC_CACHE.clear()


@pytest.fixture
def port_native_off(monkeypatch):
    monkeypatch.setattr(audio_io, "_native", lambda: None)


def _noise(n, seed=0):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


@pytest.mark.parametrize("fs_in,fs_out", RATES)
def test_resample_host_equals_jax_with_soxr(both_native, fs_in, fs_out):
    assert audio_io.resampler_route() == "soxr"
    x = _noise(fs_in)                     # one second
    got = audio_io.resample_host(x, fs_in, fs_out)
    ref = jaudio.resample_host(x, fs_in, fs_out)
    assert got.dtype == np.float32 and got.shape == ref.shape
    assert abs(got.size - fs_out) <= 16
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("fs_in,fs_out", RATES)
def test_resample_host_without_the_library_is_resample_poly(port_native_off, fs_in, fs_out):
    assert audio_io.resampler_route() == "resample_poly"
    x = _noise(4000, 1)
    g = np.gcd(fs_in, fs_out)
    np.testing.assert_array_equal(audio_io.resample_host(x, fs_in, fs_out),
                                  scipy.signal.resample_poly(x, fs_out // g, fs_in // g)
                                  .astype(np.float32))
    np.testing.assert_array_equal(audio_io.resample_host(x, fs_in, fs_in), x)


def _write_pcm(path, frames, fs, sampwidth):
    """A WAV through the standard library: int frames [n, channels]."""
    frames = np.asarray(frames, np.int64)
    if sampwidth == 3:
        b = (frames.reshape(-1)[:, None] >> np.array([0, 8, 16])) & 0xFF
        raw = b.astype(np.uint8).tobytes()
    elif sampwidth == 1:
        raw = (frames + 128).astype(np.uint8).tobytes()
    else:
        raw = frames.astype({2: "<i2", 4: "<i4"}[sampwidth]).tobytes()
    with wave.open(path, "wb") as w:
        w.setnchannels(frames.shape[1])
        w.setsampwidth(sampwidth)
        w.setframerate(fs)
        w.writeframes(raw)


WAVS = {"mono16": (1, 2), "stereo16": (2, 2), "stereo24": (2, 3), "mono32": (1, 4),
        "mono8": (1, 1)}


@pytest.mark.parametrize("kind", sorted(WAVS))
def test_wav_info_and_read_equal_jax(tmp_path, both_native, kind):
    ch, sw = WAVS[kind]
    bits = 8 * sw
    rng = np.random.default_rng(sw + ch)
    frames = rng.integers(-(2 ** (bits - 1)), 2 ** (bits - 1), size=(3001, ch))
    p = str(tmp_path / f"{kind}.wav")
    _write_pcm(p, frames, 32000, sw)
    assert audio_io.info(p) == jaudio.info(p) == (3001, 32000, ch)
    for start, n in ((0, -1), (1234, 500), (2900, 500), (5000, 10)):
        got, fs = audio_io.read(p, start, n)
        ref, fs_ref = jaudio.read(p, start, n)
        assert fs == fs_ref == 32000 and got.dtype == np.float32
        np.testing.assert_array_equal(got, ref)
    # the Python reader (no library) gives the same samples, to one f32 ulp
    # of the channel mean
    full = audio_io.read(p)[0]
    py = audio_io._read_python(p, 0, -1)[0]
    np.testing.assert_allclose(py, full, rtol=0, atol=2.0 ** -23)


def test_write_is_byte_for_byte_the_jax_write(tmp_path, both_native):
    x = np.sin(np.linspace(0, 300, 7001)).astype(np.float32) * 1.3   # clips: normalised
    a, b = str(tmp_path / "a.wav"), str(tmp_path / "b.wav")
    np.testing.assert_array_equal(audio_io.write(a, x, 48000), jaudio.write(b, x, 48000))
    assert open(a, "rb").read() == open(b, "rb").read()
    assert audio_io.info(a) == (7001, 48000, 1)


def test_without_the_library_wav_still_reads_and_flac_raises(tmp_path, port_native_off):
    p = str(tmp_path / "a.wav")
    x = _noise(900, 2) * 0.3
    jaudio.write(p, x, 16000)
    assert audio_io.info(p) == (900, 16000, 1)
    np.testing.assert_array_equal(audio_io.read(p, 100, 50)[0], jaudio.read(p, 100, 50)[0])
    q = str(tmp_path / "a.flac")
    ff.encode(q, [np.arange(300)], 16000)
    for fn in (audio_io.info, audio_io.read):
        with pytest.raises(ValueError, match="native audio library"):
            fn(q)


def _int16(rng, n, scale=12000):
    return np.clip(rng.standard_normal(n) * scale, -32768, 32767).astype(np.int64)


def _flac_cases():
    """name -> (channel recipe for _channels, encoder keywords)."""
    cases = {f"{k}{o}": (1, dict(kind=k, order=o, blocksize=256))
             for k, o in (("verbatim", 0), ("fixed", 0), ("fixed", 1), ("fixed", 2),
                          ("fixed", 3), ("fixed", 4))}
    cases["constant"] = ("const", dict(kind="constant", blocksize=256))
    cases["lpc"] = ("walk", dict(kind="lpc", lpc_coef=[55, -23, 4], lpc_shift=5,
                                 blocksize=500))
    cases["escape"] = (1, dict(kind="fixed", order=1, blocksize=512, partition_order=2,
                               rice_param=[13, "escape17", 12, 14]))
    cases["rice2"] = (1, dict(kind="fixed", order=2, blocksize=256, method=1, rice_param=14))
    cases["wasted"] = ("wasted", dict(kind="fixed", order=2, wasted=3, blocksize=400))
    for mode in ("independent", "left_side", "right_side", "mid_side"):
        cases[f"stereo_{mode}"] = (2, dict(stereo_mode=mode, kind="fixed", order=2,
                                          blocksize=300))
    cases["unknown_length"] = (1, dict(kind="fixed", order=1, blocksize=250,
                                       total_samples_field=0))
    return cases


FLAC_CASES = _flac_cases()


def _channels(what, rng, n=2000):
    if what == "const":
        return [np.full(n, -1234, np.int64)]
    if what == "walk":
        return [np.clip(np.cumsum(_int16(rng, n, scale=300)), -32768, 32767)]
    if what == "wasted":
        return [(_int16(rng, n) >> 3) << 3]
    left = _int16(rng, n)
    if what == 2:
        return [left, np.clip(left + _int16(rng, n, scale=900), -32768, 32767)]
    return [left]


@pytest.mark.parametrize("case", sorted(FLAC_CASES))
def test_flac_info_and_read_equal_jax(tmp_path, rng, both_native, case):
    what, kw = FLAC_CASES[case]
    chans = _channels(what, rng)
    p = str(tmp_path / f"{case}.flac")
    ff.encode(p, chans, 22050, **kw)
    assert audio_io.info(p) == jaudio.info(p) == (2000, 22050, len(chans))
    full, fs = audio_io.read(p)
    ref, _ = jaudio.read(p)
    assert fs == 22050 and full.shape == (2000,)
    np.testing.assert_array_equal(full, ref)
    # and it is the mono mix of the encoded integers
    expect = np.stack(chans).astype(np.float64).mean(0) / 32768.0
    np.testing.assert_allclose(full, expect.astype(np.float32), rtol=0, atol=1e-7)
    for start, n in ((1234, 377), (1900, 500), (0, 1)):
        seg = audio_io.read(p, start, n)[0]
        np.testing.assert_array_equal(seg, jaudio.read(p, start, n)[0])
        np.testing.assert_array_equal(seg, full[start:start + n])


@pytest.mark.parametrize("damage", ["frame_byte", "not_flac", "truncated"])
def test_corrupt_flac_raises_in_both(tmp_path, rng, both_native, damage):
    p = str(tmp_path / "bad.flac")
    ff.encode(p, [_int16(rng, 1000)], 16000, kind="fixed", order=2, blocksize=250)
    data = bytearray(open(p, "rb").read())
    if damage == "frame_byte":
        data[60] ^= 0xFF
    elif damage == "not_flac":
        data = bytearray(b"not a flac file at all, just bytes")
    else:
        data = data[: len(data) // 2]
    open(p, "wb").write(bytes(data))
    for mod in (audio_io, jaudio):
        mod._FLAC_CACHE.clear()
        with pytest.raises(ValueError):
            mod.read(p)


def test_flac_cache_is_lru_and_bounded(tmp_path, rng, both_native, monkeypatch):
    paths = []
    for i in range(3):
        paths.append(str(tmp_path / f"c{i}.flac"))
        ff.encode(paths[-1], [_int16(rng, 400)], 8000, kind="fixed", order=1, blocksize=200)
    monkeypatch.setattr(audio_io, "_FLAC_CACHE_MAX_SAMPLES", 900)    # two files of 400
    audio_io.read(paths[0])
    audio_io.read(paths[1])
    audio_io.read(paths[0])          # now the most recent
    audio_io.read(paths[2])          # evicts paths[1]
    assert list(audio_io._FLAC_CACHE) == [paths[0], paths[2]]


def test_a_build_that_fails_warns_with_the_compiler_output(tmp_path):
    src = tmp_path / "native"
    src.mkdir()
    (src / "audioio.cpp").write_text("this is not C++\n")
    (src / "flac.cpp").write_text("\n")
    with pytest.warns(RuntimeWarning, match="did not build(.|\n)*audioio.cpp"):
        lib, status = audio_io.build_and_load(str(src), str(tmp_path / "build"))
    assert lib is None and status.startswith("build failed")
    assert not any(p.suffix == ".tmp" for p in (tmp_path / "build").iterdir())


def test_the_library_is_built_once_per_source_content(tmp_path):
    src = tmp_path / "native"
    src.mkdir()
    for s in ("audioio.cpp", "flac.cpp"):
        (src / s).write_bytes(open(f"{audio_io.NATIVE_DIR}/{s}", "rb").read())
    lib, status = audio_io.build_and_load(str(src), str(tmp_path / "build"))
    assert lib is not None and status.startswith("loaded")
    built = sorted(p.name for p in (tmp_path / "build").iterdir())
    assert len(built) == 1 and built[0].startswith("libaudioio-") and built[0].endswith(".so")
    assert audio_io.build_and_load(str(src), str(tmp_path / "build"))[1] == status
