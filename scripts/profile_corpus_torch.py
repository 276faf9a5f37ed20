"""Where the wall of a corpus run goes, on an NVIDIA GPU.

    python scripts/profile_corpus_torch.py [--seed 0] [--repeat 1]

Writes a corpus made from ``--seed`` into a temporary directory: 48 PCM16
mono files of 5-95 s at 24 kHz (about 30 minutes), two 44.1 kHz stereo
files (resampled: f32 segments beside the int16 ones) and a tar of three
members, and the 48 files again at 16 kHz. Then, ``--repeat`` times, it
measures the encoder's device RTFx on 30 s int16 rows (``__call__``,
synchronised, median of 3) and runs ``AudioToken.encode_batch_files`` over
the corpus with 30 s segments: acoustic at B=8 and 32, semantic_s at B=8.
For each run it prints the corpus RTFx beside the device RTFx, the share
of the padded segments' samples that are audio, the executor's stage spans
and the device's busy share of the wall, from CUDA events recorded around
each ``dispatch`` (each batch's H2D copy and kernels, and any gap between
them). The last line is a JSON object of the numbers. Needs a CUDA device;
imports no JAX. ``chip_smoke.py`` phase 4e uses the same corpus and helpers.
"""

import argparse
import json
import os
import statistics
import sys
import tarfile
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from audiotoken_tpu_torch import AudioToken, Tokenizers  # noqa: E402
from audiotoken_tpu_torch.io.wavfile import write_wav  # noqa: E402

SR, SR_S = 24_000, 16_000
CORPUS_FILES = 48  # 24 kHz PCM16 mono files of 5-95 s, about 30 minutes in all
CORPUS_STEREO_S = (37.3, 12.9)  # two 44.1 kHz stereo files (resampled, f32 segments)
CORPUS_TAR_S = (8.2, 31.5, 61.0)  # a tar of three 24 kHz members
SEGMENT_S = 30


def corpus_frames(n, sr_src, sr, per_segment):
    """The tokens the corpus path gives a file of ``n`` samples at
    ``sr_src``: 30 s chunks of the source, each resampled to ``sr``
    (ceil(sr * c / sr_src) samples), dropped under 0.2 s, else
    ceil(samples / 320) tokens, at most ``per_segment``."""
    total, step = 0, SEGMENT_S * sr_src
    for start in range(0, n, step):
        m = -(-min(step, n - start) * sr // sr_src)
        if m >= int(0.2 * sr):
            total += min(-(-m // 320), per_segment)
    return total


def _pcm16(rng, n, channels=1):
    return (rng.standard_normal((channels, n)) * 3000).clip(-32768, 32767).astype(np.int16)


def make_corpus(seed, tmp):
    """Write the corpus under ``tmp``; returns a dict: ``dir`` (24 kHz, with
    the stereo files and the tar) and ``dir16`` (16 kHz), and for each
    output file name its source WAV (``sources``) and token count at 24 kHz
    (``frames``) and at 16 kHz (``frames16``), and ``seconds`` of audio."""
    rng = np.random.default_rng(seed)
    c = {"dir": os.path.join(tmp, "corpus"), "dir16": os.path.join(tmp, "corpus16"),
         "sources": {}, "frames": {}, "frames16": {}}
    members = os.path.join(tmp, "members")
    for d in (c["dir"], c["dir16"], members):
        os.makedirs(d)
    lengths = 5 + 90 * rng.beta(1.0, 2.0, CORPUS_FILES)  # mean 35 s
    for i, sec in enumerate(lengths):
        name = f"c{i:02d}"
        c["sources"][f"{name}.npy"] = path = os.path.join(c["dir"], f"{name}.wav")
        write_wav(path, _pcm16(rng, int(sec * SR)), SR)
        c["frames"][f"{name}.npy"] = corpus_frames(int(sec * SR), SR, SR, 2250)
        write_wav(os.path.join(c["dir16"], f"{name}.wav"), _pcm16(rng, int(sec * SR_S)), SR_S)
        c["frames16"][f"{name}.npy"] = corpus_frames(int(sec * SR_S), SR_S, SR_S, 1499)
    for i, sec in enumerate(CORPUS_STEREO_S):
        c["sources"][f"st{i}.npy"] = path = os.path.join(c["dir"], f"st{i}.wav")
        write_wav(path, _pcm16(rng, int(sec * 44_100), channels=2), 44_100)
        c["frames"][f"st{i}.npy"] = corpus_frames(int(sec * 44_100), 44_100, SR, 2250)
    with tarfile.open(os.path.join(c["dir"], "members.tar"), "w") as tf:
        for i, sec in enumerate(CORPUS_TAR_S):
            c["sources"][f"t{i}.npy"] = path = os.path.join(members, f"t{i}.wav")
            write_wav(path, _pcm16(rng, int(sec * SR)), SR)
            tf.add(path, arcname=f"t{i}.wav")
            c["frames"][f"t{i}.npy"] = corpus_frames(int(sec * SR), SR, SR, 2250)
    c["seconds"] = float(sum(lengths) + sum(CORPUS_STEREO_S) + sum(CORPUS_TAR_S))
    c["seconds16"] = float(sum(lengths))
    return c


def evented_dispatch(enc, events):
    """``enc.dispatch`` with a CUDA event recorded before and after each
    call: the spans between them are the device's time on each batch (its
    H2D copy and kernels, and any gap in between)."""
    run = enc.dispatch

    def dispatch(*args, **kwargs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = run(*args, **kwargs)
        end.record()
        events.append((start, end))
        return out

    return dispatch


def corpus_run(at, batch_size, outdir, audio_dir, num_workers=4):
    """``at.encode_batch_files`` over ``audio_dir`` with 30 s segments ->
    (summary, wall seconds, device busy seconds from the dispatch events,
    the device's idle seconds between one batch's end and the next one's
    start)."""
    enc, events = at.encoder, []
    enc.dispatch = evented_dispatch(enc, events)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        summary = at.encode_batch_files(batch_size=batch_size, outdir=outdir,
                                        chunk_size=SEGMENT_S, num_workers=num_workers,
                                        audio_dir=audio_dir)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        del enc.dispatch
    busy = sum(s.elapsed_time(e) for s, e in events) / 1e3
    gaps = sum(e.elapsed_time(s) for (_, e), (s, _) in zip(events, events[1:])) / 1e3
    return summary, wall, busy, gaps


def report(tag, summary, wall, busy, gaps, device_rtfx, batch_size):
    """The lines of one corpus run, and its numbers as a dict."""
    audio_s, batches = summary["audio_seconds"], summary["batches"]
    fill = audio_s / (batches * batch_size * SEGMENT_S)
    nums = {"audio_s": audio_s, "batches": batches, "wall_s": wall,
            "corpus_rtfx": audio_s / wall, "device_rtfx": device_rtfx, "segment_fill": fill,
            "busy_s": busy, "busy_share": busy / wall, "gaps_s": gaps,
            "spans": {k: v["total_s"] for k, v in summary["stages"].items()}}
    lines = [f"{tag}: {audio_s:.1f} s of audio in {batches} batches, wall {wall:.3f} s: corpus "
             f"RTFx {nums['corpus_rtfx']:.1f} (the executor's own count {summary['rtfx']}); "
             f"the encoder's device RTFx at this batch {device_rtfx:.1f}, of which the corpus "
             f"keeps {100 * nums['corpus_rtfx'] / device_rtfx:.1f} %; audio fills "
             f"{100 * fill:.1f} % of the segments' samples; device busy {busy:.3f} s = "
             f"{100 * busy / wall:.1f} % of the wall (CUDA events around each dispatch), idle "
             f"{1e3 * gaps:.1f} ms between batches and {1e3 * (wall - busy - gaps):.1f} ms "
             f"before the first and after the last"]
    for name, v in summary["stages"].items():
        lines.append(f"  span {name:13s} total {v['total_s']:.4f} s, {v['count']} calls, "
                     f"mean {v['mean_ms']:.3f} ms ({v['clock']} clock)")
    return lines, nums


def device_rtfx(enc, sr, batch_size, reps=3):
    """The encoder's RTFx on ``batch_size`` rows of 30 s int16 PCM: host
    array in, host tokens out, median of ``reps`` after a warm-up."""
    pcm = _pcm16(np.random.default_rng(1), SEGMENT_S * sr, channels=batch_size)
    enc(pcm)
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc(pcm)
        walls.append(time.perf_counter() - t0)
    return batch_size * SEGMENT_S / statistics.median(walls)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repeat", type=int, default=1)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda", 0)
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        c = make_corpus(args.seed, tmp)
        print(f"corpus (seed {args.seed}): {len(c['sources'])} files, {c['seconds']:.1f} s "
              f"({c['seconds'] / 60:.1f} min) at 24 kHz, {c['seconds16']:.1f} s at 16 kHz",
              flush=True)
        ac = AudioToken(Tokenizers.acoustic, weights="random", device=dev)
        sem = AudioToken(Tokenizers.semantic_s, weights="random", device=dev)
        ac.load_encoder()
        sem.load_encoder()
        cases = [("acoustic", ac, 8, c["dir"], SR), ("acoustic", ac, 32, c["dir"], SR),
                 ("semantic_s", sem, 8, c["dir16"], SR_S)]
        for rep in range(args.repeat):
            for name, at, B, d, sr in cases:
                rtfx = device_rtfx(at.encoder, sr, B)
                out = os.path.join(tmp, f"out_{name}_{B}_{rep}")
                lines, nums = report(f"{name} B={B} (run {rep + 1})",
                                     *corpus_run(at, B, out, d), rtfx, B)
                print("\n".join(lines), flush=True)
                results.append({"tokenizer": name, "batch": B, "run": rep + 1, **nums})
    print(json.dumps({"device": torch.cuda.get_device_name(0), "runs": results}))


if __name__ == "__main__":
    main()
