"""Command-line entry points, counterpart of ``audiotoken_tpu/cli.py``:

    python -m audiotoken_tpu_torch.cli tokenize   --tokenizer acoustic --indir D --outdir O
    python -m audiotoken_tpu_torch.cli detokenize --tokenizer acoustic --indir O --outdir W
    python -m audiotoken_tpu_torch.cli bench      --tokenizer acoustic
    python -m audiotoken_tpu_torch.cli convert    --model acoustic --src encodec_24khz.pt --out W

The encode, decode and bench commands take ``--device`` (default ``cuda``,
which raises without a GPU; ``cpu`` runs the kernels' plain versions).
``convert`` writes one checkpoint into the ``.npz`` store that
``--weights W`` reads; it runs on the host alone.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

from .configs import Tokenizers
from .convert.checkpoints import STORE
from .logger import get_logger

logger = get_logger(__name__)


def _add_common(p):
    p.add_argument("--tokenizer", choices=[t.value for t in Tokenizers], required=True)
    p.add_argument("--weights", default="artifacts",
                   help="'artifacts', 'random', or a converted-weights dir")
    p.add_argument("--precision", default="highest",
                   choices=["highest", "mixed", "high", "default", "bfloat16"],
                   help="'highest' = IEEE f32, token parity with the reference; "
                        "'high' and 'default' allow TF32; 'bfloat16' computes in bf16 "
                        "where the JAX package does; 'mixed' (semantic_m encode only) "
                        "= 'high' with the measured stages in IEEE f32")
    p.add_argument("--device", default="cuda",
                   help="torch device: 'cuda' (default; raises without a GPU) or 'cpu'")


def _audiotoken(args):
    from . import AudioToken

    return AudioToken(Tokenizers(args.tokenizer), device=args.device, weights=args.weights,
                      precision=args.precision, num_codebooks=args.num_codebooks)


def cmd_tokenize(args):
    from .io.audio import find_audio_files

    tok = _audiotoken(args)
    if args.batch_size > 1 or args.indir:
        summary = tok.encode_batch_files(
            batch_size=args.batch_size,
            outdir=args.outdir,
            chunk_size=args.chunk_size,
            num_workers=args.workers,
            audio_dir=args.indir if not args.files else None,
            audio_files=args.files or None,
        )
        print(json.dumps({k: v for k, v in summary.items() if k != "stages"}))
        return
    files = args.files or find_audio_files(args.indir)
    os.makedirs(args.outdir, exist_ok=True)
    for f in files:
        toks = tok.encode(f, chunk_size=args.chunk_size)
        base = os.path.splitext(os.path.basename(f))[0]
        np.save(os.path.join(args.outdir, f"{base}.npy"), toks[0])
        logger.info("%s -> %s tokens", f, toks.shape)


def cmd_detokenize(args):
    from .io.audio import find_files, save_audio

    tok = _audiotoken(args)
    files = args.files or find_files(args.indir, (".npy",))
    os.makedirs(args.outdir, exist_ok=True)
    sr = 24_000  # the acoustic decoder's rate, which every decode ends in

    def write(f, wav):
        base = os.path.splitext(os.path.basename(f))[0]
        out = os.path.join(args.outdir, f"{base}.wav")
        save_audio(wav, out, sr)
        logger.info("%s -> %s (%.2fs)", f, out, wav.shape[-1] / sr)

    # PCM16 quantised on the device: the float path's WAV bytes, half the D2H
    tok.load_decoder(output_dtype="int16")
    if args.tokenizer != "acoustic":
        # the three-stage semantic decode, batch_size files at a time
        B = args.batch_size or 8
        for i in range(0, len(files), B):
            grp = files[i : i + B]
            for f, wav in zip(grp, tok.decode_batch(grp)):
                write(f, wav)
        return
    for f in files:
        tokens = np.load(f)
        if tokens.ndim == 2:
            tokens = tokens[None]
        write(f, tok.decode(tokens))


def cmd_convert(args):
    """A torch checkpoint -> ``<out>/<model>.npz`` of the weight store."""
    from .convert.checkpoints import convert_checkpoint
    from .convert.store import save_params

    save_params(os.path.join(args.out, f"{args.model}.npz"),
                convert_checkpoint(args.model, args.src))
    logger.info("converted %s -> %s", args.src, args.out)


def cmd_bench(args):
    import torch

    tok = _audiotoken(args)
    sr = tok.model_sample_rate
    rng = np.random.default_rng(0)
    audio = (rng.standard_normal((args.batch_size, 30 * sr)) * 0.2).astype(np.float32)
    tok.load_encoder()
    tok.encoder(audio)  # warm-up: cuDNN's algorithm choice, the kernels' build
    t0 = time.perf_counter()
    for _ in range(args.iters):
        tok.encoder(audio)  # host tokens out: each call ends synchronised
    dt = time.perf_counter() - t0
    device = tok.device
    print(json.dumps({
        "tokenizer": args.tokenizer,
        "rtfx": round(args.iters * args.batch_size * 30 / dt, 2),
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    }))


def main(argv=None):
    p = argparse.ArgumentParser(prog="audiotoken_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("tokenize", help="encode audio files to token .npy files")
    _add_common(t)
    t.add_argument("--indir", type=str)
    t.add_argument("--files", nargs="*")
    t.add_argument("--outdir", type=str, required=True)
    t.add_argument("--chunk_size", type=float, default=30)
    t.add_argument("--batch_size", type=int, default=8)
    t.add_argument("--workers", type=int, default=4)
    t.add_argument("--num_codebooks", type=int, default=16)
    t.set_defaults(func=cmd_tokenize)

    d = sub.add_parser("detokenize", help="decode token .npy files to wavs")
    _add_common(d)
    d.add_argument("--indir", type=str)
    d.add_argument("--files", nargs="*")
    d.add_argument("--outdir", type=str, required=True)
    d.add_argument("--num_codebooks", type=int, default=8)
    d.add_argument("--batch_size", type=int, default=8,
                   help="semantic decode: files per batched device decode")
    d.set_defaults(func=cmd_detokenize)

    c = sub.add_parser("convert", help="convert torch checkpoints to the .npz store")
    c.add_argument("--model", required=True, choices=STORE)
    c.add_argument("--src", required=True)
    c.add_argument("--out", required=True)
    c.set_defaults(func=cmd_convert)

    b = sub.add_parser("bench", help="quick encode RTFx benchmark")
    _add_common(b)
    b.add_argument("--batch_size", type=int, default=8)
    b.add_argument("--iters", type=int, default=8)
    b.add_argument("--num_codebooks", type=int, default=16)
    b.set_defaults(func=cmd_bench)

    args = p.parse_args(argv)
    if getattr(args, "precision", None) == "mixed" and (
            args.tokenizer != Tokenizers.semantic_m.value or args.cmd == "detokenize"):
        # refused before any weights load
        p.error("--precision mixed is a semantic_m encoder mode; use 'highest', 'high', "
                "'default' or 'bfloat16'")
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
