"""The slice as a whole: the port's semantic_s encode against the JAX
package's and the goldens, at full width (11 HuBERT layers), on the CPU;
and the port's profiling module.

Ids must be equal. The golden battery at full width, seed 0, is checked
against ``battery_semantic_s.npz`` at the semantic_s contract of
scripts/verify_tpu_parity.py (0.9999 every case), with the audio
normalised on the host over each row's valid prefix (the port's own
copy of the golden script's norm); the api clips against
``api_semantic_s.npz``. All four seeds run on the card (chip_smoke.py 5d).
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from audiotoken_tpu import AudioToken as JaxAudioToken
from audiotoken_tpu import Tokenizers as JaxTokenizers
from audiotoken_tpu.encoders import HubertEncoder as JaxHubertEncoder
from audiotoken_tpu_torch import AudioToken, HubertEncoder, Tokenizers
from audiotoken_tpu_torch.io.wavfile import write_wav
from audiotoken_tpu_torch.runtime.profiling import StageTimers, profile_trace

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
import verify_tpu_parity as parity  # noqa: E402
from golden_cases import api_clips, battery  # noqa: E402
from test_torch_offline import offline  # noqa: E402

SR = 16_000
N = 20_800  # 1.3 s: bucket 24000
N_FRAMES = 64


@pytest.fixture(scope="module")
def jax_enc():
    return JaxHubertEncoder(weights="random", seed=0)


@pytest.fixture(scope="module")
def port_api():
    at = AudioToken(Tokenizers.semantic_s, weights="random", device="cpu")
    at.load_encoder()
    return at


@pytest.fixture(scope="module")
def port_enc(port_api):
    return port_api.encoder


@pytest.fixture(scope="module")
def jax_api(jax_enc):
    at = JaxAudioToken(JaxTokenizers.semantic_s, weights="random")
    at.encoder = jax_enc  # the same seed-0 encoder, drawn once
    return at


@pytest.fixture(scope="module")
def audio():
    raw = (np.random.default_rng(41).standard_normal((2, N)) * 0.2).astype(np.float32)
    return HubertEncoder.host_transform(raw)


@pytest.fixture(scope="module")
def wav_path(tmp_path_factory):
    rng = np.random.default_rng(42)
    t = np.arange(int(2.5 * SR)) / SR
    wav = 0.4 * np.sin(2 * np.pi * 180 * t) * (0.6 + 0.4 * np.sin(2 * np.pi * 3 * t))
    wav = (wav + 0.05 * rng.standard_normal(t.shape)).astype(np.float32)
    path = str(tmp_path_factory.mktemp("wav") / "clip.wav")
    write_wav(path, wav[None], SR)
    return path


def _host_norm(audio, lengths):
    """Normalise each row over its valid prefix, zeros after it."""
    out = np.zeros_like(audio, np.float32)
    for i, n in enumerate(lengths):
        out[i, :n] = HubertEncoder.host_transform(audio[i, :n][None])[0]
    return out


def test_f32_ids_equal(jax_enc, port_enc, audio):
    out = port_enc(audio)
    assert out.dtype == np.int16 and out.shape == (2, 1, N_FRAMES)
    assert out.min() >= 0 and out.max() < 1000
    np.testing.assert_array_equal(out, jax_enc(audio))
    ids, n_frames = port_enc.dispatch(audio)
    assert isinstance(ids, torch.Tensor) and ids.shape == (2, 74)  # the 24000 bucket
    assert n_frames == N_FRAMES
    np.testing.assert_array_equal(ids[:, None, :n_frames].numpy(), out)


def test_int16_ids_equal(jax_enc, port_enc):
    """int16 PCM is normalised on the device over each row's valid samples;
    its ids equal those of the f32 path given the host-normalised /2^15
    audio, and the JAX package's ``dispatch`` (its ``__call__`` casts
    int16 to f32 without normalising, a reference defect)."""
    raw = np.random.default_rng(43).standard_normal((2, N)) * 3000
    pcm = np.clip(np.round(raw), -32768, 32767).astype(np.int16)
    lengths = np.array([N, N - 4000], np.int32)
    pcm[1, N - 4000:] = 0
    out = port_enc(pcm, lengths)
    ids, n_frames = jax_enc.dispatch(pcm, lengths)
    np.testing.assert_array_equal(out, np.asarray(ids)[:, None, :n_frames])
    f32 = _host_norm(pcm.astype(np.float32) / 32768.0, lengths)
    np.testing.assert_array_equal(out, port_enc(f32, lengths))


def test_masks(jax_enc, port_enc, audio):
    """[B] lengths equal the [B, T] prefix mask; a non-prefix mask is sent
    whole and gives the JAX package's ids."""
    lengths = np.array([N, N - 5000], np.int32)
    x = audio * (np.arange(N)[None] < lengths[:, None])
    prefix = (np.arange(N)[None] < lengths[:, None]).astype(np.float32)
    by_len = port_enc(x, lengths)
    np.testing.assert_array_equal(by_len, port_enc(x, prefix))
    np.testing.assert_array_equal(by_len, jax_enc(x, lengths))
    holes = prefix.copy()
    holes[0, 4000:6000] = 0.0
    np.testing.assert_array_equal(port_enc(x, holes), jax_enc(x, holes))


def test_subbatch_split_invisible(port_enc, audio):
    x = np.concatenate([audio, audio[:1] * 0.5])
    whole = port_enc(x)
    saved = port_enc.max_device_batch
    try:
        port_enc.max_device_batch = 2
        np.testing.assert_array_equal(port_enc(x), whole)
    finally:
        port_enc.max_device_batch = saved


def test_features_path(jax_enc, port_enc, audio):
    """quantize=False returns the layer-11 features [B, T', 768], within
    1e-4 of the JAX package's (f32 sums in other orders; O(1) values)."""
    port_enc.quantize = jax_enc.quantize = False
    try:
        out = port_enc(audio[:1])
        ref = np.asarray(jax_enc(audio[:1]))
    finally:
        port_enc.quantize = jax_enc.quantize = True
    assert out.shape == ref.shape == (1, N_FRAMES, 768) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)


def test_both_attention_forms_agree(port_enc, audio):
    xla = HubertEncoder(weights="random", seed=0, device="cpu", attn_impl="xla")
    assert port_enc.model_cfg.attn_impl == "flash"
    np.testing.assert_array_equal(xla(audio), port_enc(audio))


def test_encode_array(jax_api, port_api, audio):
    raw = (np.random.default_rng(44).standard_normal((1, N)) * 0.3).astype(np.float32)
    np.testing.assert_array_equal(port_api.encode(raw), jax_api.encode(raw))


def test_encode_wav_path(jax_api, port_api, wav_path):
    out = port_api.encode(wav_path)
    assert out.shape == (1, 1, 124)
    np.testing.assert_array_equal(out, jax_api.encode(wav_path))


def test_encode_chunked_with_overlap(jax_api, port_api, wav_path):
    out = port_api.encode(wav_path, chunk_size=1.0, overlap=0.25)
    np.testing.assert_array_equal(out, jax_api.encode(wav_path, chunk_size=1.0, overlap=0.25))


def test_battery_seed0_golden(port_enc):
    g = np.load(os.path.join(parity.GOLD, "battery_semantic_s.npz"))
    x, lengths, names = battery(SR)
    ids = port_enc(_host_norm(x, lengths), attention_mask=lengths)
    per_case = (ids.reshape(len(names), -1) == g["ids_s0"].reshape(len(names), -1)).mean(axis=1)
    bad = [f"{n}={a:.6f}" for n, a in zip(names, per_case)
           if a < parity.case_thresh("semantic_s", n)]
    assert not bad, bad


def test_api_golden_clips(port_api, tmp_path):
    g = np.load(os.path.join(parity.GOLD, "api_semantic_s.npz"))
    for name, wav in api_clips(SR, port_api.encoder.buckets).items():
        if name == "multichunk_90s":
            path = str(tmp_path / "clip.wav")
            write_wav(path, (np.clip(wav, -1, 1) * 32767.0).astype(np.int16)[None], SR)
            toks = port_api.encode(path, chunk_size=30.0)
        else:
            toks = port_api.encode(wav[None].astype(np.float32))
        ref = g[f"tokens_{name}"]
        assert toks.shape == ref.shape, name
        assert (toks == ref).mean() >= parity.THRESH, name


def test_refusals_and_limits(port_enc, monkeypatch, tmp_path):
    # "bfloat16" is a semantic_s mode (tests/test_torch_precision.py); "mixed"
    # is semantic_m's alone, refused as the JAX get_policy refuses it
    with pytest.raises(ValueError, match="unknown precision policy 'mixed'"):
        HubertEncoder(weights="random", device="cpu", precision="mixed")
    offline(monkeypatch, tmp_path)  # weights="artifacts" with nothing staged
    with pytest.raises(FileNotFoundError, match="AUDIOTOKEN_ARTIFACTS"):
        HubertEncoder(device="cpu")
    with pytest.raises(ValueError, match="attn_impl"):
        HubertEncoder(weights="random", device="cpu", attn_impl="sdpa")
    with pytest.raises(ValueError, match="shorter than"):
        port_enc(np.zeros((1, 399), np.float32))
    assert port_enc(np.zeros((1, 400), np.float32)).shape == (1, 1, 1)


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AudioToken(Tokenizers.semantic_s, weights="random")


# --- runtime/profiling.py ----------------------------------------------------


def test_stage_timers_on_the_cpu():
    timers = StageTimers("cpu")
    assert timers.clock == "host"
    for _ in range(3):
        with timers.span("encode", sync=True):
            torch.ones(64).sum()
    with pytest.raises(KeyError):
        with timers.span("failing"):
            raise KeyError("still counted")
    s = timers.summary()
    assert list(s) == ["encode", "failing"]
    assert s["encode"]["count"] == 3 and s["encode"]["clock"] == "host"
    assert s["encode"]["total_s"] >= 0 and s["failing"]["count"] == 1
    timers.log()


def test_stage_timers_clock_names_the_device():
    """On a CUDA device synchronised spans cover device work."""
    assert StageTimers("cuda").clock == "device"
    assert StageTimers(torch.device("cpu")).clock == "host"


def test_profile_trace(tmp_path):
    with profile_trace(None):
        torch.ones(3).sum()
    logdir = tmp_path / "trace"
    with profile_trace(str(logdir)):
        torch.matmul(torch.ones(8, 8), torch.ones(8, 8))
    trace = json.loads((logdir / "trace.json").read_text())
    assert trace["traceEvents"]
