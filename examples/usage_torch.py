"""End-to-end usage of the PyTorch port, ``audiotoken_tpu_torch``.

On an NVIDIA GPU, with random weights (no network):
    python examples/usage_torch.py --weights random
on the CPU (slower; a short semantic decode):
    python examples/usage_torch.py --weights random --device cpu --max-new-tokens 32
or against a converted weight store:
    python examples/usage_torch.py --weights /path/to/weights

Acoustic encode and decode of a tone, a chunked encode and a corpus of one
file, semantic_m ids, and a batched semantic decode of four id sequences
in chunks of two (``pipeline_batch``: one chunk's AR loop beside the
previous chunk's fine and acoustic stages).
"""

import argparse
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from audiotoken_tpu_torch import AudioToken, Tokenizers  # noqa: E402
from audiotoken_tpu_torch.io.audio import save_audio  # noqa: E402
from audiotoken_tpu_torch.io.wavfile import write_wav  # noqa: E402
from audiotoken_tpu_torch.metrics import si_snr  # noqa: E402


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--weights", default="random")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    p.add_argument("--max-new-tokens", type=int, default=1024,
                   help="AR tokens of the semantic decode")
    args = p.parse_args()

    workdir = tempfile.mkdtemp(prefix="audiotoken_torch_demo_")
    sr = 24_000
    t = np.arange(3 * sr) / sr
    wav = (0.4 * np.sin(2 * np.pi * 220 * t) * np.exp(-t / 2)).astype(np.float32)
    wav_path = os.path.join(workdir, "tone.wav")
    write_wav(wav_path, wav[None], sr)
    print(f"demo audio: {wav_path} ({len(wav) / sr:.1f} s), device {args.device}")

    # --- acoustic tokens: encode / decode -------------------------------
    tok = AudioToken(Tokenizers.acoustic, weights=args.weights, num_codebooks=8,
                     device=args.device)
    codes = tok.encode(wav_path)
    print(f"acoustic codes: {codes.shape} {codes.dtype} (75 a second x 8 codebooks)")
    recon = tok.decode(codes)
    out_path = os.path.join(workdir, "recon.wav")
    save_audio(recon, out_path, sr)
    print(f"round trip: {out_path}  SI-SNR {si_snr(recon[0], wav):.1f} dB")

    # --- chunked encode, and a corpus of one file -----------------------
    print(f"chunked encode: {tok.encode(wav_path, chunk_size=1.0).shape}")
    outdir = os.path.join(workdir, "tokens")
    tok.encode_batch_files(batch_size=4, outdir=outdir, chunk_size=1.0, num_workers=2,
                           audio_files=[wav_path])
    print(f"corpus tokens: {np.load(os.path.join(outdir, 'tone.npy')).shape}")

    # --- semantic tokens, and their decode ------------------------------
    sem = AudioToken(Tokenizers.semantic_m, weights=args.weights, device=args.device)
    ids = sem.encode(wav_path)
    print(f"semantic_m ids: {ids.shape} (50 a second, codebook 2048)")
    sem.load_decoder(max_new_tokens=args.max_new_tokens)
    rng = np.random.default_rng(0)
    sources = [ids.reshape(-1).astype(np.int32)] + [rng.integers(0, 2048, 150) for _ in range(3)]
    wavs = sem.decoder.decode_batch(sources, seed=0, pipeline_batch=2)
    print("semantic decode, 4 sources in chunks of 2: "
          + ", ".join(f"{w.shape[1] / sr:.2f} s" for w in wavs))


if __name__ == "__main__":
    main()
