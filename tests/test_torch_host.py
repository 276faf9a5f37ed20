"""The port's host-side modules against the JAX package's: bucketing, the
resampler, the WAV reader and writer, and chunked WAV streaming. All are
numpy on both sides, so results must be equal bit for bit."""

import numpy as np
import pytest

from audiotoken_tpu.io import audio as jax_audio
from audiotoken_tpu.io import wavfile as jax_wavfile
from audiotoken_tpu.io.resample import resample_np as jax_resample_np
from audiotoken_tpu.runtime import bucketing as jax_bucketing
from audiotoken_tpu_torch.io import audio, resample, wavfile
from audiotoken_tpu_torch.runtime import bucketing


@pytest.mark.parametrize("sr,hop,lo,hi", [(24000, 320, 1.0, 32.0), (16000, 320, 1.0, 32.0),
                                          (24000, 320, 0.5, 8.0)])
def test_default_buckets_equal(sr, hop, lo, hi):
    assert (bucketing.default_buckets(sr, hop, lo, hi)
            == jax_bucketing.default_buckets(sr, hop, lo, hi))


@pytest.mark.parametrize("n", [1, 320, 24000, 24001, 36000, 720000, 800000])
def test_pad_to_bucket_equal(n):
    buckets = bucketing.default_buckets(24000, 320)
    x = np.random.default_rng(n).standard_normal((2, n)).astype(np.float32)
    ref, _mask = jax_bucketing.pad_to_bucket(x, buckets, 0.0)
    np.testing.assert_array_equal(bucketing.pad_to_bucket(x, buckets, 0.0), ref)


@pytest.mark.parametrize("orig,new", [(16000, 24000), (44100, 24000), (48000, 24000),
                                      (24000, 16000)])
def test_resample_equal(orig, new):
    x = np.random.default_rng(orig).standard_normal((2, orig // 10 + 7)).astype(np.float32)
    out = resample.resample_np(x, orig, new)
    np.testing.assert_array_equal(out, jax_resample_np(x, orig, new))
    assert out.shape == (2, -(-new * x.shape[1] // orig))


@pytest.mark.parametrize("channels,dtype", [(1, np.float32), (2, np.float32), (1, np.int16)])
def test_wav_roundtrip_equal(tmp_path, channels, dtype):
    rng = np.random.default_rng(channels)
    x = (0.5 * rng.standard_normal((channels, 5000))).clip(-1, 1).astype(np.float32)
    if dtype == np.int16:
        x = (x * 32767).astype(np.int16)
    port_path, jax_path = str(tmp_path / "port.wav"), str(tmp_path / "jax.wav")
    wavfile.write_wav(port_path, x, 22050)
    jax_wavfile.write_wav(jax_path, x, 22050)
    assert open(port_path, "rb").read() == open(jax_path, "rb").read()
    out, sr = wavfile.read_wav(port_path)
    ref, ref_sr = jax_wavfile.read_wav(port_path)
    assert sr == ref_sr == 22050 and out.shape == (channels, 5000)
    np.testing.assert_array_equal(out, ref)


def test_convert_audio_equal():
    x = np.random.default_rng(2).standard_normal((2, 3000)).astype(np.float32)
    np.testing.assert_array_equal(audio.convert_audio(x, 16000, 24000),
                                  jax_audio.convert_audio(x, 16000, 24000))
    with pytest.raises(RuntimeError, match="mono or stereo"):
        audio.convert_audio(np.zeros((3, 10), np.float32), 24000, 24000)


@pytest.mark.parametrize("sr,channels", [(24000, 1), (44100, 2)])
def test_read_and_stream_wav_equal(tmp_path, sr, channels):
    x = (0.3 * np.random.default_rng(sr).standard_normal((channels, int(1.7 * sr))))
    path = str(tmp_path / "clip.wav")
    wavfile.write_wav(path, x.astype(np.float32), sr)
    np.testing.assert_array_equal(audio.read_audio(path, 24000),
                                  jax_audio.read_audio(path, 24000))
    chunks = [c for c, _ in audio.process_audio_chunks(path, None, 24000, 0.5)]
    ref = [c for c, _ in jax_audio.process_audio_chunks(path, None, 24000, 0.5)]
    assert len(chunks) == len(ref) == 4
    for c, r in zip(chunks, ref):
        assert c.dtype == np.float32
        np.testing.assert_array_equal(c, r)
