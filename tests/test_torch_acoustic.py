"""The slice as a whole: the port's acoustic encode against the JAX
package's, at full width on short audio, on the CPU.

Codes must be equal and latents within 2e-5. Inputs come from per-test
numpy generators; the battery row is checked against the committed goldens
under the per-case acoustic contract of scripts/verify_tpu_parity.py.
"""

import os
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from audiotoken_tpu import AudioToken as JaxAudioToken
from audiotoken_tpu import Tokenizers as JaxTokenizers
from audiotoken_tpu.encoders import AcousticEncoder as JaxAcousticEncoder
from audiotoken_tpu.nn.seanet import SeanetConfig as JaxSeanetConfig
from audiotoken_tpu.nn.seanet import seanet_encode
from audiotoken_tpu_torch import AcousticEncoder, AudioToken, Tokenizers
from audiotoken_tpu_torch.io.wavfile import write_wav
from audiotoken_tpu_torch.runtime.precision import get_policy

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
import verify_tpu_parity as parity  # noqa: E402
from golden_cases import battery  # noqa: E402
from test_torch_offline import offline  # noqa: E402

SR = 24_000
N = 31_234  # 1.3 s, not a multiple of the 320-sample hop: bucket 36000


@pytest.fixture(scope="module")
def jax_enc():
    return JaxAcousticEncoder(weights="random", seed=0)


@pytest.fixture(scope="module")
def port_enc():
    return AcousticEncoder(weights="random", seed=0, device="cpu")


@pytest.fixture(scope="module")
def audio():
    return (np.random.default_rng(11).standard_normal((2, N)) * 0.3).astype(np.float32)


@pytest.fixture(scope="module")
def wav_path(tmp_path_factory):
    rng = np.random.default_rng(12)
    t = np.arange(int(2.5 * SR)) / SR
    wav = 0.4 * np.sin(2 * np.pi * 220 * t) * (0.6 + 0.4 * np.sin(2 * np.pi * 2 * t))
    wav = (wav + 0.05 * rng.standard_normal(t.shape)).astype(np.float32)
    path = str(tmp_path_factory.mktemp("wav") / "clip.wav")
    write_wav(path, wav[None], SR)
    return path


@pytest.fixture(scope="module")
def jax_api():
    return JaxAudioToken(JaxTokenizers.acoustic, weights="random", num_codebooks=16)


@pytest.fixture(scope="module")
def port_api():
    return AudioToken(Tokenizers.acoustic, weights="random", num_codebooks=16, device="cpu")


def test_f32_codes_equal(jax_enc, port_enc, audio):
    out = port_enc(audio)
    assert out.dtype == np.int16 and out.shape == (2, 16, -(-N // 320))
    np.testing.assert_array_equal(out, jax_enc(audio))


def test_int16_codes_equal(jax_enc, port_enc, audio):
    pcm = np.clip(np.round(audio * 32768), -32768, 32767).astype(np.int16)
    out = port_enc(pcm)
    np.testing.assert_array_equal(out, jax_enc(pcm))
    np.testing.assert_array_equal(out, port_enc(pcm.astype(np.float32) / 32768.0))


def test_latents_close(jax_enc, port_enc, audio):
    """Latents within atol 2e-5 at a speech-like input level (std 0.03).

    With zero biases and ELU the latents scale with the input: here their
    std is about 0.7. f32 rounding in the 3584-term conv_out sums, taken in
    another order by each package, is a few ulp of the latent's size, so at
    ten times this input level the two packages differ by up to 2.5e-5."""
    x = np.pad(audio * 0.1, ((0, 0), (0, 36000 - N)))  # the bucket-padded input
    ref = np.asarray(jax.jit(seanet_encode, static_argnums=2)(
        jax_enc.params["encoder"], x, JaxSeanetConfig()))
    with torch.inference_mode(), get_policy("highest").numerics():
        out = port_enc.seanet(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (2, -(-36000 // 320), 128)
    np.testing.assert_allclose(out, ref, atol=2e-5)


def test_tokens_defined_on_bucket_padded_input(jax_enc, audio):
    """The last frame's extra right padding sees the bucket's zeros: an
    encoder without bucket padding agrees on every frame but the last."""
    ref = jax_enc(audio)
    unpadded = AcousticEncoder(weights="random", seed=0, device="cpu")
    unpadded.buckets = (N,)
    exact = unpadded(audio)
    np.testing.assert_array_equal(exact[:, :, :-1], ref[:, :, :-1])
    assert (exact[:, :, -1] != ref[:, :, -1]).any()


def test_subbatch_split_invisible(port_enc, audio):
    x = np.concatenate([audio, audio[:1] * 0.5])
    whole = port_enc(x)
    split = AcousticEncoder(weights="random", seed=0, device="cpu")
    split.max_device_batch = 1
    np.testing.assert_array_equal(split(x), whole)


def test_encode_wav_path(jax_api, port_api, wav_path):
    out = port_api.encode(wav_path)
    assert out.shape == (1, 16, 188)
    np.testing.assert_array_equal(out, jax_api.encode(wav_path))


def test_encode_chunked_with_overlap(jax_api, port_api, wav_path):
    out = port_api.encode(wav_path, chunk_size=1.0, overlap=0.25)
    assert out.shape == (1, 16, 188)
    np.testing.assert_array_equal(out, jax_api.encode(wav_path, chunk_size=1.0, overlap=0.25))


def test_encode_resampled_stereo_wav(jax_api, port_api, tmp_path):
    """A 16 kHz stereo file goes through downmix and the resampler first."""
    rng = np.random.default_rng(13)
    path = str(tmp_path / "stereo16k.wav")
    write_wav(path, (0.2 * rng.standard_normal((2, 16000))).astype(np.float32), 16000)
    out = port_api.encode(path)
    assert out.shape == (1, 16, 75)
    np.testing.assert_array_equal(out, jax_api.encode(path))


def test_encode_array(jax_api, port_api, audio):
    np.testing.assert_array_equal(port_api.encode(audio[:1]), jax_api.encode(audio[:1]))
    with pytest.raises(ValueError):
        port_api.encode(audio)  # [2, T] is not one mono clip


def test_battery_seed0_golden():
    g = np.load(os.path.join(parity.GOLD, "battery_acoustic.npz"))
    x, _lengths, names = battery(SR)
    ids = AcousticEncoder(weights="random", seed=0, device="cpu")(x)
    ref = g["ids_s0"]
    per_case = (ids == ref).reshape(len(names), -1).mean(axis=1)
    bad = [f"{n}={a:.6f}" for n, a in zip(names, per_case)
           if a < parity.case_thresh("acoustic", n)]
    assert not bad, bad


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AudioToken(Tokenizers.acoustic, weights="random")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AcousticEncoder(weights="random")


def test_later_slices_raise(port_api, wav_path, monkeypatch, tmp_path):
    # semantic_s has arrived (tests/test_torch_semantic_s.py), and so have
    # the converters behind weights="artifacts" (tests/test_torch_convert.py):
    # with nothing staged and no hub, the default weights name the directory
    offline(monkeypatch, tmp_path)
    with pytest.raises(FileNotFoundError, match="AUDIOTOKEN_ARTIFACTS"):
        AudioToken(Tokenizers.semantic_s, device="cpu").load_encoder()
    # bytes input has arrived (the native libav decoder): it answers
    np.testing.assert_array_equal(port_api.encode(Path(wav_path).read_bytes()),
                                  port_api.encode(wav_path))
    # decode has arrived (tests/test_torch_acoustic_decode.py): it answers
    wav = port_api.decode(np.zeros((1, 16, 4), np.int16))
    assert wav.shape == (1, 4 * 320) and wav.dtype == np.float32
    # the corpus executor has arrived (tests/test_torch_corpus.py): it
    # checks its arguments
    with pytest.raises(ValueError, match="audio_files or audio_dir"):
        port_api.encode_batch_files(batch_size=2, outdir="unused")
    # a non-WAV path goes to the native decoder, which names what it could not open
    with pytest.raises(ValueError, match="could not open"):
        port_api.encode("clip.flac")


def test_precision_policies(port_enc, audio):
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    with get_policy("high").numerics():
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == saved
    with pytest.raises(ValueError, match="unknown precision"):
        get_policy("mixed")  # as in the JAX package, "mixed" is semantic_m's alone
    bf16 = AcousticEncoder(weights="random", seed=0, device="cpu", precision="bfloat16")
    out = bf16(audio[:1, :8000])
    assert out.shape == (1, 16, 25) and out.dtype == np.int16
