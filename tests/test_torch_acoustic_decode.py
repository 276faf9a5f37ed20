"""The port's acoustic decode against the JAX package's, on the CPU, at full
width on short code sequences.

RVQ decode is bit-equal (the same gathers added in the same order); the
transposed conv and the SEANet decoder agree within 1e-5 of the output's
scale (f32 sums in another order); int16 output within one LSB of the JAX
package's on >= 0.9999 of the samples (an f32 difference of 1e-5 of the
scale can cross a rounding boundary), and byte-equal to the port's own
float path written as WAV.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiotoken_tpu.decoders import AcousticDecoder as JaxAcousticDecoder
from audiotoken_tpu.nn.rvq import rvq_decode as jax_rvq_decode
from audiotoken_tpu.nn.seanet import SeanetConfig as JaxSeanetConfig
from audiotoken_tpu.nn.seanet import seanet_decode
from audiotoken_tpu.ops.conv import conv_transpose1d as jax_conv_transpose1d
from audiotoken_tpu.weights import get_acoustic_params as jax_get_acoustic_params
from audiotoken_tpu_torch import AcousticDecoder, AudioToken, Tokenizers
from audiotoken_tpu_torch.io.wavfile import write_wav
from audiotoken_tpu_torch.nn.rvq import rvq_decode
from audiotoken_tpu_torch.nn.seanet import SeanetDecoder
from audiotoken_tpu_torch.ops.conv import conv_transpose1d
from audiotoken_tpu_torch.weights import acoustic_decoder_from_numpy, get_acoustic_params

REL = 1e-5


def _codes(seed, B, T, K=8):
    return np.random.default_rng(seed).integers(0, 1024, size=(B, K, T)).astype(np.int32)


@pytest.fixture(scope="module")
def port_dec():
    return AcousticDecoder(weights="random", seed=0, device="cpu")


@pytest.fixture(scope="module")
def jax_dec():
    return JaxAcousticDecoder(weights="random", seed=0)


def test_rvq_decode_bitwise_equal():
    cb = get_acoustic_params("random", 0)["codebooks"]
    codes = _codes(1, 2, 17)
    out = rvq_decode(torch.from_numpy(cb), torch.from_numpy(codes)).numpy()
    np.testing.assert_array_equal(out, np.asarray(jax_rvq_decode(jnp.asarray(cb), codes)))


@pytest.mark.parametrize("stride,trim", [(4, 1.0), (5, 0.5), (2, 0.0)])
def test_conv_transpose1d_matches_jax(stride, trim):
    rng = np.random.default_rng(stride)
    x = rng.standard_normal((2, 13, 16)).astype(np.float32)  # JAX layout [B, T, C_in]
    kernel = (rng.standard_normal((2 * stride, 8, 16)) * 0.2).astype(np.float32)  # [K, C_out, C_in]
    bias = rng.standard_normal(8).astype(np.float32)
    ref = np.asarray(jax_conv_transpose1d(x, kernel, bias, stride, trim_right_ratio=trim))
    out = conv_transpose1d(torch.from_numpy(x).transpose(1, 2),
                           torch.from_numpy(kernel.transpose(2, 1, 0).copy()),
                           torch.from_numpy(bias), stride, trim).transpose(1, 2).numpy()
    assert out.shape == ref.shape == (2, 13 * stride, 8)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_seanet_decoder_matches_jax():
    params = get_acoustic_params("random", 2)
    z = np.random.default_rng(3).standard_normal((2, 21, 128)).astype(np.float32)
    ref = np.asarray(seanet_decode(jax_get_acoustic_params("random", 2)["decoder"],
                                   jnp.asarray(z), JaxSeanetConfig()))
    dec = SeanetDecoder()
    dec.load_state_dict(acoustic_decoder_from_numpy(params)[0])
    with torch.inference_mode():
        out = dec(torch.from_numpy(z)).numpy()
    assert out.shape == ref.shape == (2, 21 * 320)
    np.testing.assert_allclose(out, ref, rtol=0, atol=REL * np.abs(ref).max())


def test_acoustic_decoder_matches_jax(port_dec, jax_dec):
    codes = _codes(4, 2, 30)
    out, ref = port_dec(codes), jax_dec(codes)
    assert out.shape == ref.shape == (1, 2 * 30 * 320) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=0, atol=REL * np.abs(ref).max())


def test_int16_output(port_dec, tmp_path):
    """int16 output: the WAV bytes of the float path (clamped to 0.99 as
    the reference's save_audio does), and within one LSB of JAX's."""
    codes = _codes(5, 1, 30)
    wav_f = port_dec(codes)
    dec_i = AcousticDecoder(weights="random", seed=0, device="cpu", output_dtype="int16")
    wav_i = dec_i(codes)
    assert wav_i.dtype == np.int16 and wav_i.shape == wav_f.shape
    write_wav(str(tmp_path / "f.wav"), np.clip(wav_f, -0.99, 0.99), 24_000)
    write_wav(str(tmp_path / "i.wav"), wav_i, 24_000)
    assert (tmp_path / "f.wav").read_bytes() == (tmp_path / "i.wav").read_bytes()
    ref = JaxAcousticDecoder(weights="random", seed=0, output_dtype="int16")(codes)
    diff = np.abs(wav_i.astype(np.int32) - ref.astype(np.int32))
    assert (diff <= 1).mean() >= 0.9999


def test_auto_split_invisible():
    """B = 9 in sub-batches of 4 (a partial last one) equals one batch."""
    codes = _codes(6, 9, 12)
    whole = AcousticDecoder(weights="random", device="cpu", max_device_batch=None)(codes)
    split = AcousticDecoder(weights="random", device="cpu", max_device_batch=4)(codes)
    np.testing.assert_allclose(split, whole, rtol=0, atol=REL * np.abs(whole).max())


def test_api_decode_and_decode_batch(port_dec, tmp_path):
    at = AudioToken(Tokenizers.acoustic, num_codebooks=8, weights="random", device="cpu")
    codes = _codes(7, 1, 20)
    np.save(tmp_path / "c.npy", codes)
    wav = at.decode(str(tmp_path / "c.npy"))
    assert wav.shape == (1, 20 * 320) and wav.dtype == np.float32
    np.testing.assert_array_equal(wav, port_dec(codes))
    outs = at.decode_batch([codes, codes, _codes(8, 1, 11)])
    assert [w.shape for w in outs] == [(1, 6400), (1, 6400), (1, 3520)]
    np.testing.assert_allclose(outs[1], wav, rtol=0, atol=REL * np.abs(wav).max())
