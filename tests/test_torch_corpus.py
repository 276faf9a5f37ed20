"""The corpus path: the port's segment stream, token sink and
``encode_batch_files`` against the JAX package's, on the CPU.

Batches, configs and token files must be equal bit for bit: acoustic at
full width (seed 0, three clips of 0.7-2.5 s, 1 s chunks, batch 2) and
semantic_s at full width on 16 kHz PCM16 clips (the int16 passthrough, the
host normalisation done on the device). The executor's behaviour mirrors
``tests/test_api.py``: reruns, a corrupt file, the ``audio_dir`` layout,
several hosts through the port's ``parallel/hosts.py``, and a writer
failure that raises rather than hangs. Inputs come from per-test numpy
generators.
"""

import json
import os
import shutil
import tarfile
import threading
from dataclasses import asdict

import numpy as np
import pytest
import torch

from audiotoken_tpu import AudioToken as JaxAudioToken
from audiotoken_tpu import Tokenizers as JaxTokenizers
from audiotoken_tpu.configs import AudioConfig as JaxAudioConfig
from audiotoken_tpu.io.dataset import AudioSegmentStream as JaxStream
from audiotoken_tpu.io.dataset import batched_segments as jax_batched_segments
from audiotoken_tpu.io.sink import TokenSink as JaxTokenSink
from audiotoken_tpu_torch import AudioToken, HubertEncoder, Tokenizers
from audiotoken_tpu_torch.configs import AcousticEncoderConfig, AudioConfig
from audiotoken_tpu_torch.io.dataset import AudioSegmentStream, batched_segments
from audiotoken_tpu_torch.io.sink import TokenSink
from audiotoken_tpu_torch.io.wavfile import write_wav
from audiotoken_tpu_torch.parallel import hosts
from audiotoken_tpu_torch.runtime import executor

SR = 24_000
SR_S = 16_000
SECONDS = (1.0, 2.5, 0.7)


def _write(path, seconds, sr, rng, int16=False, channels=1):
    n = int(sr * seconds)
    x = (0.25 * rng.standard_normal((channels, n))).clip(-1, 1).astype(np.float32)
    write_wav(str(path), (x * 32767).astype(np.int16) if int16 else x, sr)


@pytest.fixture(scope="module")
def wav_dir(tmp_path_factory):
    rng = np.random.default_rng(7)
    d = tmp_path_factory.mktemp("wavs")
    for i, seconds in enumerate(SECONDS):
        _write(d / f"a{i}.wav", seconds, SR, rng)
    return d


@pytest.fixture(scope="module")
def mixed_dir(tmp_path_factory):
    """PCM16 mono at 16 kHz (int16-eligible) beside 44.1 kHz stereo (f32,
    resampled), so that one batch holds both kinds of segment."""
    rng = np.random.default_rng(8)
    d = tmp_path_factory.mktemp("mixed")
    _write(d / "m0.wav", 0.5, SR_S, rng, int16=True)
    _write(d / "m1.wav", 1.3, 44_100, rng, channels=2)
    _write(d / "m2.wav", 0.9, SR_S, rng, int16=True)
    _write(d / "m3.wav", 0.1, SR_S, rng, int16=True)  # shorter than a segment's 0.2 s
    return d


def _files(d):
    return sorted(str(p) for p in d.glob("*.wav"))


@pytest.fixture(scope="module")
def port_api():
    return AudioToken(Tokenizers.acoustic, weights="random", num_codebooks=16, device="cpu")


@pytest.fixture(scope="module")
def jax_api():
    return JaxAudioToken(JaxTokenizers.acoustic, weights="random", num_codebooks=16)


def _center(w):
    return w - np.mean(w, axis=-1, keepdims=True)


# (prefer_int16, transform, transform_int16_passthrough, drop_last, batch_size)
STREAM_CASES = {
    "int16": (True, None, False, False, 2),
    "f32": (False, None, False, False, 2),
    "drop_last": (True, None, False, True, 2),
    "transform_f32": (True, _center, False, False, 3),
    "transform_int16_passthrough": (True, _center, True, False, 3),
}


@pytest.mark.parametrize("case", sorted(STREAM_CASES))
def test_batched_segments_equal(mixed_dir, case):
    prefer, transform, passthrough, drop_last, bs = STREAM_CASES[case]
    kw = dict(pad_token=0, transform=transform, prefer_int16=prefer,
              transform_int16_passthrough=passthrough)
    ours = list(batched_segments(AudioSegmentStream(_files(mixed_dir), SR_S, 50, 0.5, **kw),
                                 bs, num_workers=1, drop_last=drop_last))
    ref = list(jax_batched_segments(JaxStream(_files(mixed_dir), SR_S, 50, 0.5, **kw),
                                    bs, num_workers=1, drop_last=drop_last))
    assert len(ours) == len(ref) > 0
    for (a, n, cfgs), (ra, rn, rcfgs) in zip(ours, ref):
        assert a.dtype == ra.dtype and a.shape == ra.shape == (bs, SR_S // 2)
        np.testing.assert_array_equal(a, ra)
        assert n.dtype == rn.dtype == np.int32 and n.shape == (bs,)
        np.testing.assert_array_equal(n, rn)
        assert [c and asdict(c) for c in cfgs] == [c and asdict(c) for c in rcfgs]
    names = [{os.path.basename(c.file_name) for c in cfgs if c} for _a, _n, cfgs in ours]
    if prefer and transform is None:
        # the batch of m0's segment and m1's first: int16 rows scaled beside f32
        assert {"m0.wav", "m1.wav"} <= names[0] and ours[0][0].dtype == np.float32
    if not drop_last:
        # the last partial batch repeats its last row, with None configs
        cfgs = ours[-1][2]
        n_real = sum(c is not None for c in cfgs)
        assert 0 < n_real <= bs
        for j in range(n_real, bs):
            np.testing.assert_array_equal(ours[-1][0][j], ours[-1][0][n_real - 1])
    assert not any("m3.wav" in s for s in names)  # too short: dropped


def test_segment_stream_several_workers(mixed_dir):
    """Several producer threads, one sentinel each: every segment arrives
    once, whatever the order."""
    stream = AudioSegmentStream(_files(mixed_dir), SR_S, 50, 0.5, prefer_int16=True)
    one = list(stream)
    got = [c for _a, _n, cfgs in batched_segments(stream, 2, num_workers=3) for c in cfgs if c]
    key = lambda c: (c.file_name, c.start_idx)  # noqa: E731
    assert sorted(map(key, got)) == sorted(key(s.config) for s in one)


@pytest.mark.parametrize("max_pending_bytes", [256 << 20, 1], ids=["in_ram", "spill"])
def test_token_sink_equal(tmp_path, max_pending_bytes):
    """Chunks arrive out of order across two files; under a small
    ``max_pending_bytes`` all but the first chunk spill to ``.staging``."""
    rng = np.random.default_rng(5)
    chunks = []
    for name, n_chunks in (("/x/f0.wav", 3), ("/x/f1.wav", 2)):
        for k in range(n_chunks):
            n = 24_000 if k < n_chunks - 1 else 9_001
            tokens = rng.integers(0, 1024, size=(4, 80)).astype(np.int16)
            fields = dict(file_name=name, start_idx=24_000 * k, end_idx=24_000 * k + n,
                          length_seconds=n / SR, length_samples=n, model_token_rate=75)
            chunks.append((tokens, fields))
    order = [4, 1, 0, 3, 2]
    outs = {}
    for tag, sink_cls, cfg_cls in (("port", TokenSink, AudioConfig),
                                   ("jax", JaxTokenSink, JaxAudioConfig)):
        out = tmp_path / tag
        sink = sink_cls(str(out), max_pending_bytes=max_pending_bytes)
        sink.finish_file("/x/f1.wav", 2)
        for i in order:
            sink.add(chunks[i][0], cfg_cls(**chunks[i][1]))
        assert [f for f, _ in sink.pending_files()] == ["/x/f0.wav"]
        sink.finish_file("/x/f0.wav", 3)
        assert sink.pending_files() == []
        assert (out / ".staging").exists() == (max_pending_bytes == 1)
        outs[tag] = {p: (out / p).read_bytes() for p in ("f0.npy", "f1.npy", "manifest.json")}
        assert not list((out / ".staging").glob("*"))  # every spilled chunk read back
    assert outs["port"] == outs["jax"]
    f0 = np.load(tmp_path / "port" / "f0.npy")
    # per-chunk trim: 75 tokens a full second, ceil(9001 / 320) for the last
    assert f0.shape == (4, 75 + 75 + 29)
    np.testing.assert_array_equal(f0[:, :75], chunks[0][0][:, :75])


def _npys(out):
    return {p.relative_to(out).as_posix(): p.read_bytes() for p in sorted(out.rglob("*.npy"))}


def test_corpus_acoustic_equal_jax(port_api, jax_api, wav_dir, tmp_path):
    files = _files(wav_dir)
    kw = dict(batch_size=2, chunk_size=1.0, num_workers=2, audio_files=files)
    summary = port_api.encode_batch_files(outdir=tmp_path / "port", **kw)
    jax_api.encode_batch_files(outdir=tmp_path / "jax", **kw)
    ours, ref = _npys(tmp_path / "port"), _npys(tmp_path / "jax")
    assert sorted(ours) == ["a0.npy", "a1.npy", "a2.npy"]
    assert ours == ref
    for i, seconds in enumerate(SECONDS):
        toks = np.load(tmp_path / "port" / f"a{i}.npy")
        assert toks.shape == (16, int(np.ceil(seconds * 75))) and toks.dtype == np.int16
        np.testing.assert_array_equal(toks, port_api.encode(files[i], chunk_size=1.0)[0])
    assert summary["batches"] == 3 and summary["audio_seconds"] == pytest.approx(sum(SECONDS))
    assert set(summary["stages"]) == {"segment_wait", "dispatch", "writeq_put", "d2h_fetch",
                                      "sink_write"}
    assert "failed_files" not in summary


def test_corpus_semantic_s_equal_jax(tmp_path):
    """The int16 passthrough on both sides: PCM16 at 16 kHz reaches each
    package's ``dispatch`` raw and is normalised on the device."""
    rng = np.random.default_rng(9)
    d = tmp_path / "wavs16"
    d.mkdir()
    for i, seconds in enumerate((1.4, 0.6)):
        _write(d / f"s{i}.wav", seconds, SR_S, rng, int16=True)
    port = AudioToken(Tokenizers.semantic_s, weights="random", device="cpu")
    port.load_encoder()
    assert port.encoder.accepts_int16 and port.encoder.int16_device_transform
    stream = AudioSegmentStream(_files(d), SR_S, 50, 1.0,
                                transform=HubertEncoder.host_transform, prefer_int16=True,
                                transform_int16_passthrough=True)
    assert all(s.audio.dtype == np.int16 for s in stream)
    jax = JaxAudioToken(JaxTokenizers.semantic_s, weights="random")
    kw = dict(batch_size=2, chunk_size=1.0, num_workers=1, audio_dir=d)
    port.encode_batch_files(outdir=tmp_path / "port", **kw)
    jax.encode_batch_files(outdir=tmp_path / "jax", **kw)
    ours = _npys(tmp_path / "port")
    assert sorted(ours) == ["s0.npy", "s1.npy"] and ours == _npys(tmp_path / "jax")
    # a full 1 s segment gives HuBERT's 49 frames (the sink's trim to its 50
    # takes them all), the 0.4 s rest of the file 20
    assert np.load(tmp_path / "port" / "s0.npy").shape == (1, 49 + 20)


def test_rerun_is_idempotent(port_api, wav_dir, tmp_path):
    out = tmp_path / "tokens"
    kw = dict(batch_size=2, outdir=out, chunk_size=1.0, num_workers=1,
              audio_files=_files(wav_dir))
    assert port_api.encode_batch_files(**kw)["batches"] == 3
    mtimes = {p: os.path.getmtime(out / p) for p in ("a0.npy", "a1.npy", "a2.npy")}
    assert port_api.encode_batch_files(**kw)["batches"] == 0
    assert {p: os.path.getmtime(out / p) for p in mtimes} == mtimes
    assert np.load(out / "a1.npy").shape == (16, int(np.ceil(2.5 * 75)))  # not doubled


def test_corrupt_file_does_not_stop_corpus(port_api, wav_dir, tmp_path):
    corpus = tmp_path / "corpus"
    corpus.mkdir()
    for p in wav_dir.glob("*.wav"):
        shutil.copy(p, corpus / p.name)
    (corpus / "broken.wav").write_bytes(b"RIFFgarbage-not-a-wav")
    out = tmp_path / "tokens"
    port_api.encode_batch_files(batch_size=2, outdir=out, chunk_size=1.0, num_workers=2,
                                audio_dir=corpus)
    for i in range(3):
        assert (out / f"a{i}.npy").exists()
    assert not (out / "broken.npy").exists()


def test_audio_dir_relative_layout(port_api, jax_api, wav_dir, tmp_path):
    corpus = tmp_path / "corpus"
    (corpus / "sub" / "deeper").mkdir(parents=True)
    shutil.copy(wav_dir / "a0.wav", corpus / "a0.wav")
    shutil.copy(wav_dir / "a2.wav", corpus / "sub" / "deeper" / "a2.wav")
    kw = dict(batch_size=2, chunk_size=1.0, num_workers=1, audio_dir=corpus)
    port_api.encode_batch_files(outdir=tmp_path / "port", **kw)
    jax_api.encode_batch_files(outdir=tmp_path / "jax", **kw)
    ours = _npys(tmp_path / "port")
    assert sorted(ours) == ["a0.npy", "sub/deeper/a2.npy"]
    assert ours == _npys(tmp_path / "jax")


def test_short_member_does_not_end_the_tar(port_api, jax_api, tmp_path):
    """A tar member too short for one segment, between two others. The port
    writes all three (the short one as an empty [0, 0] array) and goes on;
    the JAX package's sink raises a KeyError when it records the empty file
    (``audiotoken_tpu/io/sink.py:_maybe_flush`` deletes a pending entry the
    file never had), which ends the tar there, so the member after it is
    never written (ROADMAP.md, Queue 3)."""
    rng = np.random.default_rng(10)
    members = {"t0.wav": 0.5, "t1.wav": 0.1, "t2.wav": 0.6}
    for name, seconds in members.items():
        _write(tmp_path / name, seconds, SR, rng)
    tar_path = tmp_path / "corpus.tar"
    with tarfile.open(tar_path, "w") as tf:
        for name in members:
            tf.add(tmp_path / name, arcname=name)
    kw = dict(batch_size=2, chunk_size=1.0, num_workers=1, audio_files=[str(tar_path)])
    port_api.encode_batch_files(outdir=tmp_path / "port", **kw)
    jax_api.encode_batch_files(outdir=tmp_path / "jax", **kw)
    ours, ref = _npys(tmp_path / "port"), _npys(tmp_path / "jax")
    assert sorted(ours) == ["t0.npy", "t1.npy", "t2.npy"]
    assert np.load(tmp_path / "port" / "t1.npy").shape == (0, 0)
    assert sorted(ref) == ["t0.npy", "t1.npy"]  # the reference's defect
    assert {k: ours[k] for k in ref} == ref
    np.testing.assert_array_equal(np.load(tmp_path / "port" / "t2.npy"),
                                  port_api.encode(str(tmp_path / "t2.wav"))[0])


class TestHosts:
    def _run_as_host(self, monkeypatch, api, files, out, pi, pc):
        monkeypatch.setattr(hosts, "process_count", lambda: pc)
        monkeypatch.setattr(hosts, "process_index", lambda: pi)
        return api.encode_batch_files(batch_size=2, outdir=out, chunk_size=1.0,
                                      num_workers=1, audio_files=files)

    def test_defaults_without_a_process_group(self):
        assert (hosts.process_index(), hosts.process_count()) == (0, 1)
        files = ["c", "a", "b", "d", "e"]
        assert hosts.shard_files_for_host(files) == ["a", "b", "c", "d", "e"]
        assert hosts.shard_files_for_host(files, 1, 2) == ["b", "d"]
        assert hosts.shard_files_for_host(files, 2, 3) == ["c"]

    def test_two_hosts_shared_outdir(self, port_api, wav_dir, tmp_path, monkeypatch):
        out = tmp_path / "tokens"
        files = _files(wav_dir)
        for pi in (0, 1):
            self._run_as_host(monkeypatch, port_api, files, out, pi, 2)
        for i in range(3):
            assert (out / f"a{i}.npy").exists()
        m0 = json.loads((out / "manifest.p0.json").read_text())["completed"]
        m1 = json.loads((out / "manifest.p1.json").read_text())["completed"]
        assert set(m0) == set(hosts.shard_files_for_host(files, 0, 2))
        assert set(m1) == set(hosts.shard_files_for_host(files, 1, 2))
        assert not set(m0) & set(m1)
        mtimes = {i: os.path.getmtime(out / f"a{i}.npy") for i in range(3)}
        for pi in (0, 1):
            assert self._run_as_host(monkeypatch, port_api, files, out, pi, 2)["batches"] == 0
        assert {i: os.path.getmtime(out / f"a{i}.npy") for i in range(3)} == mtimes

    def test_reshard_to_three_hosts_resumes_from_union(self, port_api, wav_dir, tmp_path,
                                                       monkeypatch):
        out = tmp_path / "tokens"
        files = _files(wav_dir)
        for pi in (0, 1):
            self._run_as_host(monkeypatch, port_api, files, out, pi, 2)
        mtimes = {i: os.path.getmtime(out / f"a{i}.npy") for i in range(3)}
        _write(tmp_path / "a3.wav", 1.0, SR, np.random.default_rng(3))
        files2 = sorted(files + [str(tmp_path / "a3.wav")])
        summaries = [self._run_as_host(monkeypatch, port_api, files2, out, pi, 3)
                     for pi in range(3)]
        assert sum(s["batches"] > 0 for s in summaries) == 1
        assert (out / "a3.npy").exists()
        assert {i: os.path.getmtime(out / f"a{i}.npy") for i in range(3)} == mtimes
        manifests = [json.loads(p.read_text())["completed"]
                     for p in sorted(out.glob("manifest.p*.json"))]
        flat = [f for m in manifests for f in m]
        assert len(flat) == len(set(flat)) == len(files2)
        for pi in range(3):
            assert self._run_as_host(monkeypatch, port_api, files2, out, pi, 3)["batches"] == 0


class _Poison:
    """A device result whose fetch fails, as a device fault would."""

    def __array__(self, *a, **k):
        raise RuntimeError("simulated device failure")


class _BadEncoder:
    accepts_int16 = False

    def __init__(self, result_cls, with_dispatch):
        self.result_cls = result_cls
        if with_dispatch:
            self.dispatch = lambda audio, lengths: (self.result_cls(), 0)

    def __call__(self, audio, lengths):
        return self.result_cls()


@pytest.mark.parametrize("with_dispatch", [True, False], ids=["via_dispatch", "via_call"])
@pytest.mark.parametrize("depth", [1, 4])
def test_writer_failure_raises_not_hangs(wav_dir, tmp_path, with_dispatch, depth):
    result = {}

    def run():
        try:
            executor.encode_batch_files(_BadEncoder(_Poison, with_dispatch),
                                        AcousticEncoderConfig(), batch_size=1,
                                        outdir=tmp_path / "out", audio_dir=wav_dir,
                                        chunk_size=0.5, pipeline_depth=depth)
        except BaseException as e:  # noqa: BLE001  (handed to the test's thread)
            result["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive(), "encode_batch_files hung after a writer failure"
    err = result.get("error")
    assert isinstance(err, RuntimeError) and "token writer failed" in str(err)
    assert "simulated device failure" in str(err.__cause__)


def test_start_fetch_cpu_tensor():
    codes = torch.arange(12, dtype=torch.int16).reshape(2, 2, 3)
    out = executor.start_fetch(codes)()
    assert isinstance(out, np.ndarray) and out.dtype == np.int16
    np.testing.assert_array_equal(out, codes.numpy())


def test_encode_batch_files_arguments(port_api, wav_dir, tmp_path):
    with pytest.raises(ValueError, match="audio_files or audio_dir"):
        port_api.encode_batch_files(batch_size=2, outdir=tmp_path / "o")
    with pytest.raises(ValueError, match="not both"):
        port_api.encode_batch_files(batch_size=2, outdir=tmp_path / "o",
                                    audio_files=_files(wav_dir), audio_dir=wav_dir)


def test_meter_summary():
    m = executor.ThroughputMeter()
    m.update(30.0)
    m.update(12.5)
    s = m.summary()
    assert s["batches"] == 2 and s["audio_seconds"] == 42.5 and s["rtfx"] > 0


def test_archive_members_stay_in_outdir(port_api, jax_api, wav_dir, tmp_path, monkeypatch):
    """A tar found under ``audio_dir``: its members' names are relative to
    the tar, not to ``audio_dir``. The port writes their tokens flat in
    ``outdir``, as with ``audio_files``; the JAX sink joins
    ``relpath(member, audio_dir)`` to ``outdir``, so they land beside the
    current directory instead (``audiotoken_tpu/io/sink.py:_out_path``;
    ROADMAP.md, Queue 3)."""
    corpus = tmp_path / "corpus"
    corpus.mkdir()
    shutil.copy(wav_dir / "a0.wav", corpus / "a0.wav")
    with tarfile.open(corpus / "members.tar", "w") as tf:
        tf.add(wav_dir / "a2.wav", arcname="m2.wav")
    cwd = tmp_path / "cwd"
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    kw = dict(batch_size=2, chunk_size=1.0, num_workers=1, audio_dir=corpus)
    port_api.encode_batch_files(outdir=tmp_path / "port", **kw)
    jax_api.encode_batch_files(outdir=tmp_path / "jax", **kw)
    ours = _npys(tmp_path / "port")
    assert sorted(ours) == ["a0.npy", "m2.npy"]
    assert sorted(_npys(tmp_path / "jax")) == ["a0.npy"]  # the reference's defect
    assert (cwd / "m2.npy").read_bytes() == ours["m2.npy"]


def test_rerun_skips_finished_archive(port_api, jax_api, wav_dir, tmp_path):
    """Once every member of a tar is written, the port's manifest records
    the tar itself, and a rerun skips it unread. The JAX manifest records
    only the members' names, never the tar's path, so its rerun reads and
    encodes the tar again and rewrites the same files
    (``audiotoken_tpu/runtime/executor.py``'s ``is_done`` filter; ROADMAP.md,
    Queue 3)."""
    tar_path = tmp_path / "corpus.tar"
    with tarfile.open(tar_path, "w") as tf:
        for i in (0, 2):
            tf.add(wav_dir / f"a{i}.wav", arcname=f"m{i}.wav")
    kw = dict(batch_size=2, chunk_size=1.0, num_workers=1, audio_files=[str(tar_path)])
    for tag, api in (("port", port_api), ("jax", jax_api)):
        out = tmp_path / tag
        assert api.encode_batch_files(outdir=out, **kw)["batches"] == 1
        first = _npys(out)
        assert sorted(first) == ["m0.npy", "m2.npy"]
        rerun = api.encode_batch_files(outdir=out, **kw)["batches"]
        assert rerun == (0 if tag == "port" else 1)  # the reference's defect: 1
        assert _npys(out) == first
    completed = json.loads((tmp_path / "port" / "manifest.json").read_text())["completed"]
    assert sorted(completed) == sorted([str(tar_path), "m0.wav", "m2.wav"])
    assert _npys(tmp_path / "port") == _npys(tmp_path / "jax")


def test_token_sink_threads_stress(tmp_path):
    """More threads than cores add chunks and finish files at once, with a
    short switch interval and a spill threshold that some chunks cross:
    every file is written once, its chunks in order."""
    import sys

    n_files, n_chunks, n_threads = 24, 5, 3 * (os.cpu_count() or 2)
    rng = np.random.default_rng(12)
    toks = rng.integers(0, 1024, size=(n_files, n_chunks, 2, 75)).astype(np.int16)
    sink = TokenSink(str(tmp_path), max_pending_bytes=40 * toks[0, 0].nbytes)
    jobs = [("add", f, k) for f in range(n_files) for k in range(n_chunks)]
    jobs += [("finish", f, n_chunks) for f in range(n_files)]
    jobs = [jobs[i] for i in rng.permutation(len(jobs))]

    def work(share):
        for kind, f, k in share:
            if kind == "finish":
                sink.finish_file(f"/c/f{f:02d}.wav", k)
            else:
                sink.add(toks[f, k], AudioConfig(
                    file_name=f"/c/f{f:02d}.wav", start_idx=24_000 * k,
                    end_idx=24_000 * (k + 1), length_seconds=1.0, length_samples=24_000,
                    model_token_rate=75))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(jobs[i::n_threads],))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert sink.pending_files() == []
    for f in range(n_files):
        np.testing.assert_array_equal(np.load(tmp_path / f"f{f:02d}.npy"),
                                      np.concatenate(list(toks[f]), axis=1))
    completed = json.loads((tmp_path / "manifest.json").read_text())["completed"]
    assert len(completed) == len(set(completed)) == n_files
