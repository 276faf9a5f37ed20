"""The port's native libav decoder and the non-WAV io paths against the
JAX package's, on the CPU.

Decoded samples must equal the JAX native decoder's bit for bit (the same
C++), and the WAV parser's within 1 LSB of int16 (the decoder mixes stereo
down in another order); tar and zip chunks must equal JAX's. Without the
library every non-WAV input raises an error naming it, and WAV still
decodes. No other container encoder is at hand here, so non-WAV paths are
exercised by WAV content under another extension, which libav identifies
by its header.
"""

import shutil
import tarfile
import zipfile

import numpy as np
import pytest

from audiotoken_tpu.io import _native as jax_native
from audiotoken_tpu.io import audio as jax_audio
from audiotoken_tpu_torch import AudioToken, Tokenizers
from audiotoken_tpu_torch.io import _native, audio
from audiotoken_tpu_torch.io.wavfile import read_wav, write_wav

LSB = 1.0 / 32768


@pytest.fixture(scope="module")
def lib():
    if not _native.native_available():
        pytest.skip(f"the native decoder did not build (log: {_native.build_log_path()})")
    if not jax_native.native_available():
        pytest.skip("the JAX package's native decoder did not build")
    return _native


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    """mono PCM16 at 24 kHz, stereo PCM16 at 44.1 kHz, mono float at 16 kHz."""
    rng = np.random.default_rng(21)
    d = tmp_path_factory.mktemp("native")
    out = {}
    for name, sr, ch, dtype, seconds in (("mono16", 24_000, 1, np.int16, 1.7),
                                         ("stereo16", 44_100, 2, np.int16, 2.3),
                                         ("monof32", 16_000, 1, np.float32, 0.9)):
        x = (0.3 * rng.standard_normal((ch, int(sr * seconds)))).clip(-1, 1)
        x = (x * 32767).astype(np.int16) if dtype == np.int16 else x.astype(np.float32)
        path = d / f"{name}.wav"
        write_wav(str(path), x, sr)
        out[name] = path
    return out


def _jax_decode(source):
    with jax_native.NativeDecoder(source) as dec:
        parts = list(dec.chunks(1 << 20))
        return np.concatenate(parts)[None], dec.sample_rate


def test_library_is_built_by_hash():
    if not _native.native_available():
        pytest.skip(f"the native decoder did not build (log: {_native.build_log_path()})")
    so = _native.library_path()
    assert so.exists() and so.parent.name == "_build"
    assert so.name.startswith("libaudioio_") and len(so.stem.split("_")[-1]) == 16


@pytest.mark.parametrize("name", ["mono16", "stereo16", "monof32"])
def test_path_and_bytes_equal_jax_and_wav_parser(lib, wavs, name):
    path = wavs[name]
    with lib.NativeDecoder(str(path)) as dec:
        out, sr = dec.read_all(), dec.sample_rate
        assert dec.channels == (2 if name == "stereo16" else 1)
    ref, ref_sr = _jax_decode(str(path))
    assert sr == ref_sr and out.dtype == np.float32
    np.testing.assert_array_equal(out, ref)
    with lib.NativeDecoder(path.read_bytes()) as dec:
        np.testing.assert_array_equal(dec.read_all(), out)
    with open(path, "rb") as f, lib.NativeDecoder(f) as dec:
        np.testing.assert_array_equal(dec.read_all(), out)
    parsed, parsed_sr = read_wav(str(path))
    assert parsed_sr == sr and out.shape == (1, parsed.shape[1])
    np.testing.assert_allclose(out, parsed.mean(axis=0, keepdims=True), rtol=0, atol=LSB)


def test_chunks_cover_the_stream(lib, wavs):
    with lib.NativeDecoder(str(wavs["stereo16"])) as dec:
        frames = dec.duration_frames
        chunks = list(dec.chunks(10_000))
    assert [c.size for c in chunks[:-1]] == [10_000] * (len(chunks) - 1)
    assert sum(c.size for c in chunks) == frames == int(44_100 * 2.3)


@pytest.mark.parametrize("name,sr,chunk", [("stereo16", 24_000, 1.0), ("monof32", 16_000, 0.5),
                                           ("mono16", 16_000, 0.7)])
def test_non_wav_chunks_equal_jax(lib, wavs, tmp_path, name, sr, chunk):
    """The native branch of process_audio_chunks and read_audio: a file
    named .flac holding WAV content."""
    flac = tmp_path / f"{name}.flac"
    shutil.copy(wavs[name], flac)
    ours = list(audio.process_audio_chunks(str(flac), None, sr, chunk))
    ref = list(jax_audio.process_audio_chunks(str(flac), None, sr, chunk))
    assert len(ours) == len(ref) > 1
    for (c, n), (rc, rn) in zip(ours, ref):
        assert n == rn == str(flac) and c.dtype == rc.dtype == np.float32
        np.testing.assert_array_equal(c, rc)
    np.testing.assert_array_equal(audio.read_audio(str(flac), sr),
                                  jax_audio.read_audio(str(flac), sr))


@pytest.mark.parametrize("kind", ["tar", "zip"])
def test_archive_chunks_equal_jax(wavs, tmp_path, kind):
    members = {"a/mono16.wav": wavs["mono16"], "stereo16.wav": wavs["stereo16"],
               "monof32.wav": wavs["monof32"]}
    path = tmp_path / f"corpus.{kind}"
    if kind == "tar":
        with tarfile.open(path, "w") as tf:
            for arc, p in members.items():
                tf.add(p, arcname=arc)
        ours, ref = audio.iterate_tar(path, 24_000, 0.5), jax_audio.iterate_tar(path, 24_000, 0.5)
    else:
        with zipfile.ZipFile(path, "w") as zf:
            for arc, p in members.items():
                zf.write(p, arcname=arc)
        ours, ref = audio.iterate_zip(path, 24_000, 0.5), jax_audio.iterate_zip(path, 24_000, 0.5)
    ours, ref = list(ours), list(ref)
    assert [n for _c, n in ours] == [n for _c, n in ref]
    assert {n for _c, n in ours} == set(members)
    for (c, _n), (rc, _rn) in zip(ours, ref):
        np.testing.assert_array_equal(c, rc)


@pytest.mark.parametrize("name", ["mono16", "stereo16"])
def test_prefer_int16_equal_jax(wavs, name):
    """PCM16 mono at the target rate streams as raw int16; anything else as
    float32, as in the JAX package."""
    kw = dict(prefer_int16=True)
    ours = list(audio.process_audio_chunks(str(wavs[name]), None, 24_000, 0.5, **kw))
    ref = list(jax_audio.process_audio_chunks(str(wavs[name]), None, 24_000, 0.5, **kw))
    assert ours[0][0].dtype == (np.int16 if name == "mono16" else np.float32)
    for (c, _n), (rc, _rn) in zip(ours, ref):
        assert c.dtype == rc.dtype
        np.testing.assert_array_equal(c, rc)


def test_encode_bytes_equals_path(lib, wavs):
    at = AudioToken(Tokenizers.acoustic, weights="random", num_codebooks=4, device="cpu")
    for name in ("mono16", "stereo16"):
        path = wavs[name]
        np.testing.assert_array_equal(at.encode(path.read_bytes()), at.encode(str(path)))


def test_without_the_library_non_wav_raises(wavs, tmp_path, monkeypatch):
    monkeypatch.setattr(_native, "_load", lambda: None)
    flac = tmp_path / "x.flac"
    shutil.copy(wavs["mono16"], flac)
    with pytest.raises(RuntimeError, match="native libav decoder"):
        audio.read_audio(str(flac), 24_000)
    with pytest.raises(RuntimeError, match="native libav decoder"):
        list(audio.process_audio_chunks(str(flac), None, 24_000, 1.0))
    at = AudioToken(Tokenizers.acoustic, weights="random", num_codebooks=2, device="cpu")
    with pytest.raises(RuntimeError, match="native libav decoder"):
        at.encode(wavs["mono16"].read_bytes())
    # WAV keeps its numpy parser
    assert at.encode(str(wavs["mono16"])).shape == (1, 2, int(np.ceil(1.7 * 75)))


def test_failed_build_is_logged(tmp_path, monkeypatch):
    bad = tmp_path / "audioio.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(_native, "SOURCE", bad)
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "_build")
    assert _native._load_locked.__wrapped__() is None
    log = _native.build_log_path()
    assert log.parent == tmp_path / "_build" and "g++" in log.read_text()
    assert not list((tmp_path / "_build").glob("*.so"))
    with pytest.raises(RuntimeError, match="did not build"):
        raise _native.unavailable_error("x.flac")


def test_unreadable_source_raises(lib, tmp_path):
    with pytest.raises(ValueError, match="could not open"):
        lib.NativeDecoder(str(tmp_path / "missing.flac"))
    with pytest.raises(ValueError, match="could not open"):
        lib.NativeDecoder(b"not audio at all")
