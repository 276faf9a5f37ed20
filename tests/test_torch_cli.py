"""The port's CLI and host utilities against the JAX package's, on the CPU.

``tokenize`` must write the JAX CLI's token files bit for bit and
``detokenize`` its WAVs within 1 LSB of int16, both with ``--device cpu``
and random weights at full width; ``save_audio``, ``utils`` and
``metrics`` must equal the JAX package's. Inputs come from per-test numpy
generators.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from audiotoken_tpu import metrics as jax_metrics
from audiotoken_tpu import utils as jax_utils
from audiotoken_tpu.cli import main as jax_main
from audiotoken_tpu.configs import AudioConfig as JaxAudioConfig
from audiotoken_tpu.io.audio import save_audio as jax_save_audio
from audiotoken_tpu_torch import metrics, utils
from audiotoken_tpu_torch.cli import main
from audiotoken_tpu_torch.configs import AudioConfig
from audiotoken_tpu_torch.io.audio import save_audio
from audiotoken_tpu_torch.io.wavfile import read_wav, write_wav

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    rng = np.random.default_rng(31)
    d = tmp_path_factory.mktemp("cli_wavs")
    for i in range(2):
        n = 24_000 + i * 6_000
        write_wav(str(d / f"x{i}.wav"), (rng.standard_normal(n) * 0.2).astype(np.float32)[None],
                  24_000)
    return d


def _tokenize(fn, wavs, out, *extra):
    fn(["tokenize", "--tokenizer", "acoustic", "--weights", "random", "--indir", str(wavs),
        "--outdir", str(out), "--chunk_size", "1.0", "--batch_size", "2", "--workers", "1",
        *extra])


def _read(out):
    return {p.name: p.read_bytes() for p in sorted(out.glob("*.npy"))}


@pytest.mark.parametrize("num_codebooks", ["4", "16"])
def test_tokenize_equal_jax(wavs, tmp_path, num_codebooks):
    _tokenize(main, wavs, tmp_path / "port", "--num_codebooks", num_codebooks, "--device", "cpu")
    _tokenize(jax_main, wavs, tmp_path / "jax", "--num_codebooks", num_codebooks)
    ours = _read(tmp_path / "port")
    assert sorted(ours) == ["x0.npy", "x1.npy"] and ours == _read(tmp_path / "jax")
    assert np.load(tmp_path / "port" / "x0.npy").shape == (int(num_codebooks), 75)


def test_tokenize_one_at_a_time(wavs, tmp_path):
    """--batch_size 1 with --files: AudioToken.encode per file, not the
    corpus executor; the same tokens."""
    files = [str(wavs / "x0.wav"), str(wavs / "x1.wav")]
    main(["tokenize", "--tokenizer", "acoustic", "--weights", "random", "--files", *files,
          "--outdir", str(tmp_path / "one"), "--chunk_size", "1.0", "--batch_size", "1",
          "--num_codebooks", "4", "--device", "cpu"])
    _tokenize(main, wavs, tmp_path / "batch", "--num_codebooks", "4", "--device", "cpu")
    assert _read(tmp_path / "one") == _read(tmp_path / "batch")


def test_detokenize_equal_jax(wavs, tmp_path):
    toks = tmp_path / "toks"
    _tokenize(main, wavs, toks, "--num_codebooks", "8", "--device", "cpu")
    args = ["detokenize", "--tokenizer", "acoustic", "--weights", "random", "--indir", str(toks),
            "--num_codebooks", "8"]
    main(args + ["--outdir", str(tmp_path / "port"), "--device", "cpu"])
    jax_main(args + ["--outdir", str(tmp_path / "jax")])
    for name in ("x0.wav", "x1.wav"):
        ours, sr = read_wav(str(tmp_path / "port" / name))
        ref, ref_sr = read_wav(str(tmp_path / "jax" / name))
        assert sr == ref_sr == 24_000 and ours.shape == ref.shape
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1.0 / 32768)
    assert read_wav(str(tmp_path / "port" / "x0.wav"))[0].shape == (1, 75 * 320)


def test_default_device_is_cuda(wavs, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _tokenize(main, wavs, tmp_path / "out")


def test_convert_raises(tmp_path):
    """convert has arrived (tests/test_torch_convert.py): a missing
    checkpoint raises, and nothing is written."""
    with pytest.raises(FileNotFoundError):
        main(["convert", "--model", "acoustic", "--src", str(tmp_path / "x.pt"),
              "--out", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()


def test_bench_on_the_cpu(capsys):
    main(["bench", "--tokenizer", "acoustic", "--weights", "random", "--batch_size", "1",
          "--iters", "1", "--num_codebooks", "2", "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert '"tokenizer": "acoustic"' in line and '"device": "cpu"' in line


def test_runs_as_a_module():
    proc = subprocess.run([sys.executable, "-m", "audiotoken_tpu_torch.cli", "--help"],
                          cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0
    assert all(c in proc.stdout for c in ("tokenize", "detokenize", "convert", "bench"))


@pytest.mark.parametrize("kind", ["int16", "float", "float_rescale", "int16_rescale"])
def test_save_audio_equal_jax(tmp_path, kind):
    rng = np.random.default_rng(32)
    wav = rng.standard_normal((1, 4_001)).astype(np.float32) * 0.7
    if kind.startswith("int16"):
        wav = (wav.clip(-1, 1) * 32767).astype(np.int16)
    rescale = kind.endswith("rescale")
    save_audio(wav, tmp_path / "port.wav", 24_000, rescale=rescale)
    jax_save_audio(wav, tmp_path / "jax.wav", 24_000, rescale=rescale)
    assert (tmp_path / "port.wav").read_bytes() == (tmp_path / "jax.wav").read_bytes()


def test_metrics_equal_jax():
    rng = np.random.default_rng(33)
    ref = rng.standard_normal((3, 5000))
    est = 0.8 * ref + 0.1 * rng.standard_normal((3, 5000))
    for fn, jax_fn in ((metrics.si_snr, jax_metrics.si_snr), (metrics.snr, jax_metrics.snr)):
        assert fn(est, ref) == jax_fn(est, ref)
        assert fn(est[0, :4000], ref[0]) == jax_fn(est[0, :4000], ref[0])
    assert metrics.si_snr(3.0 * ref, ref) > 100  # scale-invariant


def test_utils_equal_jax(tmp_path):
    rng = np.random.default_rng(34)
    fields = dict(file_name="/d/clip.flac", length_seconds=1.5, model_token_rate=75)
    first = rng.integers(0, 1024, (4, 80)).astype(np.int16)
    more = rng.integers(0, 1024, (4, 80)).astype(np.int16)
    for tokens in (first, more):  # the second write overwrites the first
        utils.save_audio_tokens(tokens, AudioConfig(**fields), str(tmp_path / "port"))
        jax_utils.save_audio_tokens(tokens, JaxAudioConfig(**fields), str(tmp_path / "jax"))
    ours = (tmp_path / "port" / "clip.npy").read_bytes()
    assert ours == (tmp_path / "jax" / "clip.npy").read_bytes()
    np.testing.assert_array_equal(np.load(tmp_path / "port" / "clip.npy"), more[:, :113])
    np.testing.assert_array_equal(
        utils.collate_audio_tokens(first, more, AudioConfig(**fields)),
        jax_utils.collate_audio_tokens(first, more, JaxAudioConfig(**fields)))
    d = tmp_path / "listing"
    (d / "sub").mkdir(parents=True)
    for name in ("b.wav", "sub/a.flac", "c.txt"):
        (d / name).write_bytes(b"")
    assert utils.get_dataset_files(str(d), None) == jax_utils.get_dataset_files(str(d), None)
    assert utils.get_dataset_files(str(d / "b.wav"), None) == [str(d / "b.wav")]
    with pytest.raises(ValueError):
        utils.get_dataset_files(None, None)
    utils.set_process_affinity(os.getpid(), sorted(os.sched_getaffinity(0)))
