"""Convert every upstream checkpoint to the port's ``.npz`` weight store,
check each tree against ``audiotoken_tpu_torch/convert/manifests.json``,
and smoke the store through ``AudioToken``.

    AUDIOTOKEN_ARTIFACTS=/path/to/staged python scripts/convert_real_torch.py \\
        --out /path/to/weights [--device cpu] [--skip-smoke]

A mis-staged or truncated file fails at conversion, not inside a forward
pass. Staging (the names ``audiotoken_tpu_torch/convert/checkpoints.py``
looks up: its ``STAGED``, and ``configs.ARTIFACTS`` for the others):

    $AUDIOTOKEN_ARTIFACTS/
      encodec_24khz.safetensors            # or .pt / .th: EnCodec 24 kHz state dict
      mhubert_base.safetensors             # or mhubert_base.pt, or
                                           #   voidful__mhubert-base/pytorch_model.bin
      mhubert_base_vp_en_es_fr_it3_L11_km1000.bin   # k-means (joblib; needs joblib)
      cmeraki__audiotoken/w2vbert2_l21/model.safetensors
      cmeraki__audiotoken/semantic_detokenizer/semantic_m/vq_quantizer/
          run4__quantizer__L19_C2048_ckpt8000.pkl
      cmeraki__audiotoken/semantic_detokenizer/semantic_s/
          hubert_semantic_acoustic_gpt_en.pt
      cmeraki__audiotoken/semantic_detokenizer/semantic_m/
          w2vbert2_semantic_acoustic_gpt_hi.pt
      bark_fine.pt                         # suno/bark fine checkpoint (or fine_2.pt)

Every cmeraki file may also sit flat (its basename) under the directory.
The smoke runs on ``--device`` (default ``cuda``).
"""

import argparse
import os
import sys
import traceback

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

def convert_all(root: str, out: str) -> dict:
    """Convert, check and save every store entry from the staged directory
    ``root`` into ``out`` -> {name: "OK" or "FAILED: ..."}."""
    from audiotoken_tpu_torch.convert.checkpoints import STAGED, STORE, convert_checkpoint, source
    from audiotoken_tpu_torch.convert.manifest import load_manifests, validate_tree
    from audiotoken_tpu_torch.convert.store import save_params

    manifests = load_manifests()
    os.makedirs(out, exist_ok=True)
    results = {}
    for name in STORE:
        try:
            src = source(name, root)
            if src is None:
                raise FileNotFoundError(f"stage one of {list(STAGED[name])} (see the docstring)")
            params = convert_checkpoint(name, src)
            validate_tree(params, name, manifests)
            save_params(os.path.join(out, f"{name}.npz"), params)
            results[name] = "OK"
            print(f"[convert_real_torch] {name}: OK")
        except Exception as e:  # noqa: BLE001  (report every entry, then fail)
            results[name] = f"FAILED: {e}"
            print(f"[convert_real_torch] {name}: FAILED")
            traceback.print_exc()
    return results


def smoke(out: str, results: dict, device="cuda") -> dict:
    """The store through ``AudioToken``: a one-second encode per tokenizer
    whose store converted, an acoustic round trip, a short semantic_s
    decode -> {check: "OK" or "FAILED: ..."}."""
    from audiotoken_tpu_torch import AudioToken, Tokenizers
    from audiotoken_tpu_torch.decoders import HubertDecoder

    rng = np.random.default_rng(0)
    checks = {}

    def check(name, needed, fn):
        if not all(results.get(k) == "OK" for k in needed):
            return
        try:
            fn()
            checks[name] = "OK"
            print(f"[convert_real_torch] smoke {name}: OK")
        except Exception as e:  # noqa: BLE001
            checks[name] = f"FAILED: {e}"
            print(f"[convert_real_torch] smoke {name}: FAILED")
            traceback.print_exc()

    def acoustic():
        tok = AudioToken(Tokenizers.acoustic, weights=out, num_codebooks=8, device=device)
        toks = tok.encode((rng.standard_normal((1, 24_000)) * 0.2).astype(np.float32))
        assert toks.shape == (1, 8, 75) and toks.min() >= 0
        assert np.isfinite(np.asarray(tok.decode(toks))).all()

    def semantic(tokenizer, n_ids):
        def run():
            tok = AudioToken(tokenizer, weights=out, device=device)
            ids = tok.encode((rng.standard_normal((1, 16_000)) * 0.2).astype(np.float32))
            assert ids.shape[0] == 1 and ids.min() >= 0 and ids.max() < n_ids
        return run

    def decode_s():
        dec = HubertDecoder(weights=out, max_new_tokens=64, device=device)
        assert np.isfinite(np.asarray(dec(rng.integers(0, 1000, size=50), seed=0))).all()

    check("acoustic_roundtrip", ("acoustic",), acoustic)
    check("semantic_s_encode", ("hubert", "hubert_kmeans"), semantic(Tokenizers.semantic_s, 1000))
    check("semantic_m_encode", ("w2vbert", "w2vbert_vq"), semantic(Tokenizers.semantic_m, 2048))
    check("semantic_s_decode", ("gpt_semantic_s_en", "acoustic", "bark_fine"), decode_s)
    return checks


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True, help="output weights directory")
    ap.add_argument("--artifacts", default=None,
                    help="staged artifact dir (default: $AUDIOTOKEN_ARTIFACTS)")
    ap.add_argument("--device", default="cuda", help="device of the smoke")
    ap.add_argument("--skip-smoke", action="store_true")
    args = ap.parse_args()

    root = args.artifacts or os.environ.get("AUDIOTOKEN_ARTIFACTS", "")
    if not root or not os.path.isdir(root):
        raise SystemExit("No staged artifacts: set $AUDIOTOKEN_ARTIFACTS (or --artifacts) "
                         "to a directory laid out as the docstring says.")
    results = convert_all(root, args.out)
    checks = {} if args.skip_smoke else smoke(args.out, results, args.device)
    failed = [k for k, v in {**results, **checks}.items() if v != "OK"]
    print(f"[convert_real_torch] converted {sum(v == 'OK' for v in results.values())}"
          f"/{len(results)}; smoke {sum(v == 'OK' for v in checks.values())}/{len(checks)} OK")
    if failed:
        raise SystemExit(f"[convert_real_torch] FAILURES: {failed}")
    print("[convert_real_torch] ALL OK")


if __name__ == "__main__":
    main()
