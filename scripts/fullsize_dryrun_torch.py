"""The port's converters against full-size checkpoints, on the CPU.

No real checkpoint is in the repository, so this script writes random
checkpoints at the real artifacts' full size, in their on-disk formats and
namings (``FULLSIZE_DRYRUN.md``'s table): HF safetensors for EnCodec 24 kHz,
mHuBERT base and w2v-BERT 2.0 trimmed to 21 layers (1024 wide), a
joblib-pickled sklearn ``MiniBatchKMeans`` (1000 x 768), a torch-saved
vector-quantize-pytorch state dict (2048 x 1024), two nanoGPT train-loop
checkpoints (``{'model': _orig_mod.-prefixed sd, 'model_args', ...}``, vocab
53,376, ``lm_head`` tied to ``wte``) and a suno Bark fine checkpoint (24 x
1024, ``{'model': _orig_mod.-prefixed sd}``). Then it runs them through
``scripts/convert_real_torch.py`` unchanged: every converter, the
manifests, the ``.npz`` store, and the four smokes through
``AudioToken(weights=<dir>)`` (acoustic round trip, semantic_s and
semantic_m encode, semantic_s decode) on the CPU. It prints each stage's
wall and the process's peak RSS.

    python -u scripts/fullsize_dryrun_torch.py [--stage DIR] [--out DIR]

Needs ``transformers``, ``safetensors``, ``scikit-learn`` and ``joblib``
to write the checkpoints (the port reads them without any of these but
``joblib``), about 5 GB of disk under ``$TMPDIR`` and 6-7 GB of memory.
Imports no JAX.
"""

import argparse
import os
import resource
import shutil
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, ".."))


def _rss_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


class Step:
    def __init__(self, name):
        self.name, self.t0 = name, time.time()

    def done(self):
        print(f"[stage] {self.name}: {time.time() - self.t0:.1f}s "
              f"(peak RSS {_rss_gb():.2f} GB)", flush=True)


def stage_all(root: str) -> None:
    import torch
    from safetensors.torch import save_file

    torch.manual_seed(0)
    os.makedirs(root, exist_ok=True)

    # --- EnCodec 24 kHz: HF default config IS the 24 kHz model ----------
    s = Step("encodec_24khz.safetensors (HF EncodecModel, full)")
    from transformers import EncodecConfig, EncodecModel

    m = EncodecModel(EncodecConfig())
    save_file(dict(m.state_dict()), os.path.join(root, "encodec_24khz.safetensors"))
    del m
    s.done()

    # --- mHuBERT base: HF default HubertConfig is the 12L/768 base ------
    s = Step("mhubert_base.safetensors (HF HubertModel, full)")
    from transformers import HubertConfig, HubertModel

    m = HubertModel(HubertConfig())
    save_file(dict(m.state_dict()), os.path.join(root, "mhubert_base.safetensors"))
    del m
    s.done()

    # --- k-means: joblib-pickled sklearn estimator (the real format) ----
    s = Step("mhubert km1000 joblib (sklearn MiniBatchKMeans 1000x768)")
    import joblib
    from sklearn.cluster import MiniBatchKMeans

    km = MiniBatchKMeans(n_clusters=1000, n_init=1)
    rng = np.random.default_rng(0)
    # fit on enough points to materialize cluster_centers_ at [1000, 768]
    km.fit(rng.standard_normal((4000, 768)))
    joblib.dump(km, os.path.join(
        root, "mhubert_base_vp_en_es_fr_it3_L11_km1000.bin"))
    s.done()

    # --- w2v-BERT l21 trim: the staged file is the already-trimmed HF
    # model (w2vbert2_l21/model.safetensors) -----------------------------
    s = Step("w2vbert2_l21/model.safetensors (HF Wav2Vec2BertModel 21L/1024)")
    from transformers import Wav2Vec2BertConfig, Wav2Vec2BertModel

    d = os.path.join(root, "cmeraki__audiotoken", "w2vbert2_l21")
    os.makedirs(d, exist_ok=True)
    m = Wav2Vec2BertModel(Wav2Vec2BertConfig(num_hidden_layers=21))
    save_file(dict(m.state_dict()), os.path.join(d, "model.safetensors"))
    del m
    s.done()

    # --- VQ: vector-quantize-pytorch state dict, torch.save'd .pkl ------
    s = Step("vq_quantizer pkl (VectorQuantize 2048x1024 state dict)")
    d = os.path.join(root, "cmeraki__audiotoken", "semantic_detokenizer",
                     "semantic_m", "vq_quantizer")
    os.makedirs(d, exist_ok=True)
    vq_sd = {
        "_codebook.initted": torch.tensor(True),
        "_codebook.cluster_size": torch.randn(1, 2048).abs(),
        "_codebook.embed": torch.randn(1, 2048, 1024) * 0.05,
        "_codebook.embed_avg": torch.randn(1, 2048, 1024) * 0.05,
    }
    torch.save(vq_sd, os.path.join(d, "run4__quantizer__L19_C2048_ckpt8000.pkl"))
    s.done()

    # --- semantic->acoustic GPTs: nanoGPT train-loop checkpoints --------
    def nanogpt_sd(seed, n_layer=12, n_embd=768, vocab=53_376, block=1024):
        g = torch.Generator().manual_seed(seed)

        def r(*shape):
            return torch.randn(*shape, generator=g) * 0.02

        sd = {"transformer.wte.weight": r(vocab, n_embd),
              "transformer.wpe.weight": r(block, n_embd),
              "transformer.ln_f.weight": torch.ones(n_embd)}
        for i in range(n_layer):
            pre = f"transformer.h.{i}"
            sd[f"{pre}.ln_1.weight"] = torch.ones(n_embd)
            sd[f"{pre}.attn.c_attn.weight"] = r(3 * n_embd, n_embd)
            sd[f"{pre}.attn.c_proj.weight"] = r(n_embd, n_embd)
            sd[f"{pre}.ln_2.weight"] = torch.ones(n_embd)
            sd[f"{pre}.mlp.c_fc.weight"] = r(4 * n_embd, n_embd)
            sd[f"{pre}.mlp.c_proj.weight"] = r(n_embd, 4 * n_embd)
        # tied head: same tensor object, as torch.save sees it in training
        sd["lm_head.weight"] = sd["transformer.wte.weight"]
        return {f"_orig_mod.{k}": v for k, v in sd.items()}

    for seed, rel in (
        (1, os.path.join("semantic_detokenizer", "semantic_s",
                         "hubert_semantic_acoustic_gpt_en.pt")),
        (2, os.path.join("semantic_detokenizer", "semantic_m",
                         "w2vbert2_semantic_acoustic_gpt_hi.pt")),
    ):
        s = Step(f"nanoGPT ckpt {os.path.basename(rel)} (12L/768, vocab 53376)")
        sd = nanogpt_sd(seed)
        path = os.path.join(root, "cmeraki__audiotoken", rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        # full train-loop envelope, as nanoGPT writes it
        torch.save(
            {"model": sd,
             "model_args": {"n_layer": 12, "n_head": 12, "n_embd": 768,
                            "block_size": 1024, "bias": False,
                            "vocab_size": 53_376, "dropout": 0.0},
             "iter_num": 8000, "best_val_loss": 1.234,
             "config": {"learning_rate": 6e-4, "max_iters": 8000}},
            path,
        )
        s.done()

    # --- bark fine: suno checkpoint (24L/1024d, _orig_mod.-prefixed) ----
    s = Step("bark_fine.pt (suno FineGPT 24L/1024d, 8 codebooks)")
    g = torch.Generator().manual_seed(3)

    def r(*shape):
        return torch.randn(*shape, generator=g) * 0.02

    E, L, V, NC, NG = 1024, 24, 1056, 8, 1
    sd = {"transformer.wpe.weight": r(1024, E),
          "transformer.ln_f.weight": torch.ones(E),
          "transformer.ln_f.bias": torch.zeros(E)}
    for i in range(NC):
        sd[f"transformer.wtes.{i}.weight"] = r(V, E)
    for i in range(NC - NG):
        sd[f"lm_heads.{i}.weight"] = r(V, E)
    for i in range(L):
        pre = f"transformer.h.{i}"
        sd[f"{pre}.ln_1.weight"] = torch.ones(E)
        sd[f"{pre}.ln_1.bias"] = torch.zeros(E)
        sd[f"{pre}.attn.c_attn.weight"] = r(3 * E, E)
        sd[f"{pre}.attn.c_proj.weight"] = r(E, E)
        sd[f"{pre}.ln_2.weight"] = torch.ones(E)
        sd[f"{pre}.ln_2.bias"] = torch.zeros(E)
        sd[f"{pre}.mlp.c_fc.weight"] = r(4 * E, E)
        sd[f"{pre}.mlp.c_proj.weight"] = r(E, 4 * E)
    # suno ships the torch.compile prefix in the file; bark/generation.py
    # strips it at load — converters must too
    sd = {f"_orig_mod.{k}": v for k, v in sd.items()}
    torch.save({"model": sd}, os.path.join(root, "bark_fine.pt"))
    s.done()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stage", default=None, help="where to write the checkpoints "
                    "(default: a new directory under $TMPDIR, removed at the end)")
    ap.add_argument("--out", default=None, help="the weight store (default: as --stage)")
    ap.add_argument("--skip-smoke", action="store_true")
    args = ap.parse_args()
    scratch = tempfile.mkdtemp(prefix="fullsize_dryrun_torch_")
    stage = args.stage or os.path.join(scratch, "stage")
    out = args.out or os.path.join(scratch, "weights")

    t0 = time.time()
    print(f"[fullsize_dryrun_torch] staging full-size checkpoints -> {stage}", flush=True)
    stage_all(stage)
    stage_gb = sum(os.path.getsize(os.path.join(d, f))
                   for d, _, fs in os.walk(stage) for f in fs) / 1e9
    print(f"[fullsize_dryrun_torch] staged {stage_gb:.2f} GB in {time.time() - t0:.1f}s",
          flush=True)

    os.environ["AUDIOTOKEN_ARTIFACTS"] = stage
    import convert_real_torch

    t1 = time.time()
    results = convert_real_torch.convert_all(stage, out)
    print(f"[fullsize_dryrun_torch] convert_all: {time.time() - t1:.1f}s "
          f"(peak RSS {_rss_gb():.2f} GB)", flush=True)
    checks = {}
    if not args.skip_smoke:
        t2 = time.time()
        checks = convert_real_torch.smoke(out, results, device="cpu")
        print(f"[fullsize_dryrun_torch] smoke: {time.time() - t2:.1f}s "
              f"(peak RSS {_rss_gb():.2f} GB)", flush=True)
    shutil.rmtree(scratch, ignore_errors=True)

    failed = [k for k, v in {**results, **checks}.items() if v != "OK"]
    print(f"[fullsize_dryrun_torch] total {time.time() - t0:.1f}s, "
          f"peak RSS {_rss_gb():.2f} GB, "
          f"convert {sum(v == 'OK' for v in results.values())}/{len(results)}, "
          f"smoke {sum(v == 'OK' for v in checks.values())}/{len(checks)}", flush=True)
    if failed:
        raise SystemExit(f"[fullsize_dryrun_torch] FAILURES: {failed}")
    print("[fullsize_dryrun_torch] ALL OK", flush=True)


if __name__ == "__main__":
    main()
