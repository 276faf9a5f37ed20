"""The slice as a whole: the port's semantic_m encode against the JAX
package's, at full width (19 conformer blocks) on short audio, on the CPU.

Ids must be equal. The golden battery at full width, seed 0, is checked
against ``battery_semantic_m.npz`` under the per-case semantic_m contract of
scripts/verify_tpu_parity.py (exactness rows, the quiet_i16 band, the
stability probes' floor and the binary silence gate): all 12 rows, in one
batch of 12 x 8 s. All four seeds and the api clips run on the card
(chip_smoke.py).
"""

import os
import sys

import numpy as np
import pytest
import torch

from audiotoken_tpu import AudioToken as JaxAudioToken
from audiotoken_tpu import Tokenizers as JaxTokenizers
from audiotoken_tpu.encoders import Wav2VecBertEncoder as JaxWav2VecBertEncoder
from audiotoken_tpu_torch import AudioToken, Tokenizers, Wav2VecBertEncoder
from audiotoken_tpu_torch.io.wavfile import write_wav

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
import verify_tpu_parity as parity  # noqa: E402
from golden_cases import battery  # noqa: E402
from test_torch_offline import offline  # noqa: E402

SR = 16_000
N = 20_800  # 1.3 s: bucket 24000
N_FRAMES = (1 + (N - 400) // 160) // 2


@pytest.fixture(scope="module")
def jax_enc():
    return JaxWav2VecBertEncoder(weights="random", seed=0)


@pytest.fixture(scope="module")
def port_api():
    at = AudioToken(Tokenizers.semantic_m, weights="random", device="cpu")
    at.load_encoder()
    return at


@pytest.fixture(scope="module")
def port_enc(port_api):
    return port_api.encoder


@pytest.fixture(scope="module")
def jax_api(jax_enc):
    at = JaxAudioToken(JaxTokenizers.semantic_m, weights="random")
    at.encoder = jax_enc  # the same seed-0 encoder, drawn once
    return at


@pytest.fixture(scope="module")
def audio():
    return (np.random.default_rng(31).standard_normal((2, N)) * 0.2).astype(np.float32)


@pytest.fixture(scope="module")
def wav_path(tmp_path_factory):
    rng = np.random.default_rng(32)
    t = np.arange(int(2.5 * SR)) / SR
    wav = 0.4 * np.sin(2 * np.pi * 220 * t) * (0.6 + 0.4 * np.sin(2 * np.pi * 2 * t))
    wav = (wav + 0.05 * rng.standard_normal(t.shape)).astype(np.float32)
    path = str(tmp_path_factory.mktemp("wav") / "clip.wav")
    write_wav(path, wav[None], SR)
    return path


def test_f32_ids_equal(jax_enc, port_enc, audio):
    out = port_enc(audio)
    assert out.dtype == np.int16 and out.shape == (2, 1, N_FRAMES)
    assert out.min() >= 0 and out.max() < 2048
    np.testing.assert_array_equal(out, jax_enc(audio))
    ids, n_frames = port_enc.dispatch(audio)
    bucket_frames = (1 + (24_000 - 400) // 160) // 2
    assert isinstance(ids, torch.Tensor) and ids.shape == (2, bucket_frames)
    assert n_frames == N_FRAMES
    np.testing.assert_array_equal(ids[:, None, :n_frames].numpy(), out)


def test_int16_ids_equal(jax_enc, port_enc, audio):
    """int16 PCM is scaled by the exact 1/2^15 on the device. The JAX
    package's ``__call__`` feeds int16 to the fbank unscaled (a reference
    defect, ROADMAP Queue 3), so it is held against JAX's ``dispatch``,
    which scales; and against the port's own f32 twin."""
    pcm = np.clip(np.round(audio * 32768), -32768, 32767).astype(np.int16)
    out = port_enc(pcm)
    ids, n_frames = jax_enc.dispatch(pcm)
    np.testing.assert_array_equal(out, np.asarray(ids)[:, None, :n_frames])
    np.testing.assert_array_equal(out, port_enc(pcm.astype(np.float32) / 32768.0))


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
    """quantize=False returns the layer-19 features [B, T', 1024]; within
    2e-3 of the JAX package's after 19 blocks of f32 matmuls summed in
    another order (the features are O(1))."""
    port_enc.quantize = jax_enc.quantize = False
    try:
        out = port_enc(audio[:1])
        ref = np.asarray(jax_enc(audio[:1]))
    finally:
        port_enc.quantize = jax_enc.quantize = True
    assert out.shape == ref.shape == (1, N_FRAMES, 1024) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=0, atol=2e-3)


def test_encode_array(jax_api, port_api, audio):
    np.testing.assert_array_equal(port_api.encode(audio[:1]), jax_api.encode(audio[:1]))


def test_encode_wav_path(jax_api, port_api, wav_path):
    out = port_api.encode(wav_path)
    assert out.shape == (1, 1, 124)
    np.testing.assert_array_equal(out, jax_api.encode(wav_path))


def test_encode_chunked_with_overlap(jax_api, port_api, wav_path):
    out = port_api.encode(wav_path, chunk_size=1.0, overlap=0.25)
    np.testing.assert_array_equal(out, jax_api.encode(wav_path, chunk_size=1.0, overlap=0.25))


def test_battery_seed0_golden(port_enc):
    g = np.load(os.path.join(parity.GOLD, "battery_semantic_m.npz"))
    x, lengths, names = battery(SR)
    ids = port_enc(x, attention_mask=lengths)
    per_case = (ids.reshape(len(names), -1) == g["ids_s0"].reshape(len(names), -1)).mean(axis=1)
    bad = []
    for name, agree in zip(names, per_case):
        if ("semantic_m", name) in parity.DEGENERATE_CASES:
            ok = parity.degenerate_ok(float(agree))
        else:
            ok = agree >= parity.case_thresh("semantic_m", name)
        if not ok:
            bad.append(f"{name}={agree:.6f}")
    assert not bad, bad


def test_refusals(audio, monkeypatch, tmp_path):
    # "mixed" and "bfloat16" are semantic_m modes (tests/test_torch_precision.py);
    # an unknown policy or stage is refused before the weights are drawn
    with pytest.raises(ValueError, match="unknown precision policy"):
        Wav2VecBertEncoder(weights="random", device="cpu", precision="fast")
    with pytest.raises(ValueError, match="unknown precision stage"):
        Wav2VecBertEncoder(weights="random", device="cpu", precision="mixed",
                           stage_overrides={"attention": "highest"})
    offline(monkeypatch, tmp_path)  # weights="artifacts" with nothing staged
    with pytest.raises(FileNotFoundError, match="AUDIOTOKEN_ARTIFACTS"):
        Wav2VecBertEncoder(device="cpu")


def test_too_short_raises(port_enc):
    with pytest.raises(ValueError, match="shorter than"):
        port_enc(np.zeros((1, 559), np.float32))
    assert port_enc(np.zeros((1, 560), np.float32)).shape == (1, 1, 1)


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Wav2VecBertEncoder(weights="random")
