"""Write the full-width semantic decode goldens for the port's check on the GPU.

    JAX_PLATFORMS=cpu python tests/torch_goldens/make_decode_goldens.py

Runs the JAX package on the CPU at full width (GPT 12 x 768, Bark-fine
24 x 1024, EnCodec 24 kHz decoder at 6 kbps), random weights from seed 0,
f32 and ``highest`` throughout, and writes
``tests/torch_goldens/decode_semantic_m_s0.npz`` with each stage's input
and output, so that each stage of the port can be held against it alone:

  sources, prompts  two semantic_m id rows (40 and 27 ids in [0, 1000)) and
                    the GPT prompts ``_ar_stage`` builds from them;
  tokens, margins   greedy (top_k=1) AR tokens, 96 per row (-1 after a
                    stop), and the top-1 minus top-2 logit margin of each
                    step from a teacher-forced ``gpt_logits`` (NaN after a
                    stop): a step with a tiny margin may flip on other hardware;
  coarse, lens      the two coarse codebooks per row, padded with Bark's
                    filler id to a shared length, and each row's length;
  fine              ``generate_fine_batch(coarse, temperature=None)``;
  wav_f32, wav_i16  the acoustic decoder's f32 and int16 waveforms of
                    ``fine`` [2, T * 320].

``chip_smoke.py`` (phase 5c) reads the file; it needs no JAX there. Takes
about two minutes and 6 GB on a CPU.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np

from audiotoken_tpu.configs import COMMONS, AcousticDecoderConfig
from audiotoken_tpu.decoders import AcousticDecoder, Wav2VecBertDecoder
from audiotoken_tpu.nn.gpt import gpt_logits
from audiotoken_tpu.weights import get_semantic_gpt_params

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "decode_semantic_m_s0.npz")
MAX_NEW = 96
HIGHEST = jax.lax.Precision.HIGHEST


def main():
    rng = np.random.default_rng(0)
    sources = [rng.integers(0, 1000, size=n) for n in (40, 27)]
    dec = Wav2VecBertDecoder(weights="random", seed=0, top_k=1, max_new_tokens=MAX_NEW,
                             precision="highest", ar_dtype="float32", ar_precision="highest",
                             fine_dtype="float32", fine_precision="highest")
    vocab = dec.config.vocab
    infer, stop = vocab.infer_token[COMMONS.ACOUSTIC], vocab.stop_token[COMMONS.ACOUSTIC]
    prompts = [np.concatenate([s + vocab.offsets[COMMONS.SEMANTIC], [infer]]).astype(np.int32)
               for s in sources]
    tokens = dec.gpt.generate_batch(prompts, max_new_tokens=MAX_NEW, temperature=0.8,
                                    top_k=1, stop_token=stop, seed=0)

    params, cfg = get_semantic_gpt_params("random", 0, "gpt_semantic_m_hi", vocab.vocab_size)
    margins = np.full(tokens.shape, np.nan, np.float32)
    for i, (p, row) in enumerate(zip(prompts, tokens)):
        n = int((row >= 0).sum())
        seq = np.concatenate([p, row[:n]])[None]
        logits = np.asarray(gpt_logits(params, jnp.asarray(seq), cfg, HIGHEST))[0]
        top2 = np.sort(logits[len(p) - 1 : len(p) - 1 + n], axis=-1)[:, -2:]
        margins[i, :n] = top2[:, 1] - top2[:, 0]
        if n < MAX_NEW:  # the stop token was the argmax at step n
            margins[i, n] = np.nan
    del params

    coarse_rows = dec._ar_stage(sources, 0)
    lens = np.array([c.shape[1] for c in coarse_rows], np.int32)
    filler = dec.bark.cfg.codebook_size
    coarse = np.full((len(lens), 2, lens.max()), filler, np.int32)
    for i, c in enumerate(coarse_rows):
        coarse[i, :, : lens[i]] = c
    fine = dec.bark.generate_fine_batch(coarse, temperature=None, seed=0).astype(np.int32)

    acoustic = dec.acoustic_decoder
    wav_f32 = np.asarray(acoustic._forward(acoustic.params, jnp.asarray(fine)))
    i16 = AcousticDecoder(config=AcousticDecoderConfig(bandwidth=6.0), weights="random",
                          seed=0, precision="highest", output_dtype="int16")
    wav_i16 = np.asarray(i16._forward(i16.params, jnp.asarray(fine)))

    np.savez_compressed(
        OUT, sources=np.stack([np.pad(s, (0, 40 - len(s)), constant_values=-1) for s in sources]),
        source_lens=np.array([len(s) for s in sources], np.int32),
        prompts=np.stack([np.pad(p, (0, 41 - len(p)), constant_values=-1) for p in prompts]),
        tokens=tokens.astype(np.int32), margins=margins, coarse=coarse, lens=lens, fine=fine,
        wav_f32=wav_f32.astype(np.float32), wav_i16=wav_i16.astype(np.int16),
    )
    print(f"wrote {OUT}: tokens {tokens.shape} (valid {(tokens >= 0).sum(axis=1)}), "
          f"min margin {np.nanmin(margins):.3e}, coarse {coarse.shape}, fine {fine.shape}, "
          f"wav {wav_f32.shape}")


if __name__ == "__main__":
    main()
