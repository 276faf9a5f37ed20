"""Semantic quantizer training: EMA vector quantization and minibatch
k-means, online over an encoder's embeddings.

Counterpart of ``audiotoken_tpu/train/vq_train.py`` (the upstream
clustering script's online ``VectorQuantize(decay=0.8)`` training, with
checkpoints every ``save_freq`` steps and resume through a processed-file
list):

  * :class:`EMAVQTrainer`: vector-quantize-pytorch's EMA codebook update
    (semantic_m's 2048 entries), Laplace-smoothed, initialised from the
    first batch, with optional dead-code replacement;
  * :func:`minibatch_kmeans_step`: Sculley's minibatch k-means (semantic_s's
    1000 centroids).

The codebook state stays on the device. Assignment is ``ops/lookup.py``'s
``nearest_centroid``; the updates are one-hot products in IEEE f32
(``get_policy("highest")``). :func:`train_quantizer` streams a corpus
through a semantic encoder with ``quantize=False``, keeps each segment's
valid frames on the device, and updates once ``batch_vectors`` are
buffered. A file counts as processed only once every one of its vectors has
been through an update: the JAX package records a file when its last
segment is read, so the vectors of the final partial buffer, which is never
trained, are skipped on resume. A file whose leading segments went through
an update and whose later ones did not is saved with that count, and a
resume reads it again from the first untrained segment, so no segment is
trained twice.
"""

import json
import os
import threading
import time
from collections import Counter
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..encoders import resolve_device
from ..logger import get_logger
from ..ops.lookup import nearest_centroid
from ..runtime.precision import get_policy
from ..runtime.profiling import StageTimers

logger = get_logger(__name__, level="INFO")

# vectors an update takes: the upstream clustering scripts' minibatch
# (sklearn MiniBatchKMeans with batch_size 64,000, max_iter 150,
# max_no_improvement 100, n_init 5, reassignment_ratio 0.5)
DEFAULT_BATCH_VECTORS = 64_000


@dataclass(frozen=True)
class VQTrainConfig:
    codebook_size: int = 2048
    dim: int = 1024
    decay: float = 0.8
    commitment_weight: float = 1.0
    eps: float = 1e-5
    # Replace codes whose EMA cluster size falls below this with random
    # batch samples (vector-quantize-pytorch's threshold_ema_dead_code; the
    # upstream training leaves it off, hence 0.0).
    threshold_ema_dead_code: float = 0.0


def _ema_update(state, x: torch.Tensor, cfg: VQTrainConfig):
    """One EMA codebook update on a flat batch x [N, D] -> (new state,
    {commit_loss (mean squared distance to the new codewords), active_frac
    (share of codes assigned in this batch)} as device scalars)."""
    codebook, cluster_size, embed_avg = state
    with get_policy("highest").numerics():
        x = x.float()
        idx = nearest_centroid(x, codebook)
        onehot = F.one_hot(idx, cfg.codebook_size).float()
        n_k = onehot.sum(dim=0)  # [C]
        embed_sum = onehot.t() @ x
        cluster_size = cfg.decay * cluster_size + (1 - cfg.decay) * n_k
        embed_avg = cfg.decay * embed_avg + (1 - cfg.decay) * embed_sum
        # Laplace smoothing (vector-quantize-pytorch's EuclideanCodebook)
        total = cluster_size.sum()
        cs = (cluster_size + cfg.eps) / (total + cfg.codebook_size * cfg.eps) * total
        codebook = embed_avg / cs[:, None]
        commit = (x - codebook[idx]).square().sum(dim=-1).mean()
        active = (n_k > 0).sum() / cfg.codebook_size
    return (codebook, cluster_size, embed_avg), {"commit_loss": commit, "active_frac": active}


class EMAVQTrainer:
    """EMA codebook state on ``device``; ``update(x)`` takes [N, D] vectors
    (a tensor, or numpy) and returns the step's metrics as floats."""

    def __init__(self, cfg: VQTrainConfig = VQTrainConfig(), seed: int = 0, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        rng = np.random.default_rng(seed)
        codebook = torch.from_numpy(
            rng.standard_normal((cfg.codebook_size, cfg.dim)).astype(np.float32)).to(self.device)
        self.state = (codebook, torch.zeros(cfg.codebook_size, device=self.device),
                      codebook.clone())
        self.steps = 0
        self._inited = False
        #: filled by train_quantizer: vectors, files_read, wall_s, timers
        self.stats = {}

    def _on_device(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device).float()

    def init_from_batch(self, x) -> None:
        """Codebook (and EMA sums) from samples of the batch x [N, D]."""
        x = self._on_device(x)
        n = x.shape[0]
        take = np.random.default_rng(self.steps).choice(
            n, size=self.cfg.codebook_size, replace=n < self.cfg.codebook_size)
        cb = x[torch.from_numpy(take).to(self.device)]
        self.state = (cb, self.state[1], cb.clone())
        self._inited = True

    def update(self, x) -> dict:
        x = self._on_device(x)
        if not self._inited:
            self.init_from_batch(x)
        self.state, metrics = _ema_update(self.state, x, self.cfg)
        self.steps += 1
        if self.cfg.threshold_ema_dead_code > 0:
            self._replace_dead(x)
        return {k: float(v) for k, v in metrics.items()}

    def _replace_dead(self, x: torch.Tensor) -> None:
        codebook, cluster_size, embed_avg = (s.clone() for s in self.state)
        thr = self.cfg.threshold_ema_dead_code
        dead = cluster_size < thr
        n_dead = int(dead.sum())
        if n_dead == 0:
            return
        take = np.random.default_rng(self.steps).choice(
            x.shape[0], size=n_dead, replace=x.shape[0] < n_dead)
        codebook[dead] = x[torch.from_numpy(take).to(self.device)]
        cluster_size[dead] = thr
        embed_avg[dead] = codebook[dead] * thr
        self.state = (codebook, cluster_size, embed_avg)

    @property
    def codebook(self) -> np.ndarray:
        return self.state[0].cpu().numpy()

    def save(self, path: str) -> None:
        """npz with the JAX trainer's keys: codebook, cluster_size,
        embed_avg, steps."""
        codebook, cluster_size, embed_avg = (s.cpu().numpy() for s in self.state)
        np.savez(path, codebook=codebook, cluster_size=cluster_size, embed_avg=embed_avg,
                 steps=self.steps)

    def load(self, path: str) -> None:
        with np.load(path) as z:
            self.state = tuple(torch.from_numpy(z[k]).to(self.device)
                               for k in ("codebook", "cluster_size", "embed_avg"))
            self.steps = int(z["steps"])
        self._inited = True


def minibatch_kmeans_step(centroids: torch.Tensor, counts: torch.Tensor, x: torch.Tensor,
                          num_clusters: int):
    """Sculley's minibatch k-means update, a per-centre learning rate of
    1 / count -> (centroids, counts, inertia)."""
    with get_policy("highest").numerics():
        x = x.float()
        idx = nearest_centroid(x, centroids)
        onehot = F.one_hot(idx, num_clusters).float()
        n_k = onehot.sum(dim=0)
        sum_k = onehot.t() @ x
        new_counts = counts + n_k
        lr = torch.where(n_k > 0, n_k / new_counts.clamp(min=1.0), 0.0)
        batch_mean = sum_k / n_k.clamp(min=1.0)[:, None]
        centroids = centroids + lr[:, None] * (batch_mean - centroids)
        inertia = (x - centroids[idx]).square().sum(dim=-1).mean()
    return centroids, new_counts, inertia


def _encoder(tokenizer: str, weights: str, device):
    from ..configs import HubertEncoderConfig, Wav2VecBertConfig
    from ..encoders import HubertEncoder, Wav2VecBertEncoder

    if tokenizer == "semantic_m":
        cfg = Wav2VecBertConfig()
        enc = Wav2VecBertEncoder(cfg, weights=weights, quantize=False, device=device)
    elif tokenizer == "semantic_s":
        cfg = HubertEncoderConfig()
        enc = HubertEncoder(cfg, weights=weights, quantize=False, device=device)
    else:
        raise ValueError(f"quantizer training targets semantic tokenizers, got {tokenizer}")
    return enc, cfg


def train_quantizer(
    tokenizer: str,
    indir: str,
    outdir: str,
    batch_vectors: int = DEFAULT_BATCH_VECTORS,
    save_freq: int = 100,
    chunk_size: float = 10.0,
    encode_batch: int = 8,
    num_workers: int = 2,
    weights: str = "artifacts",
    max_steps: Optional[int] = None,
    device="cuda",
) -> EMAVQTrainer:
    """Stream a corpus's embeddings and train the quantizer online, with
    resume through ``outdir/processed_files.json`` (``files``: the files
    whose every segment was trained; ``partial``: for the others, the count
    of their leading segments that were) and ``outdir/quantizer_state.npz``;
    the final codebook goes to ``outdir/<tokenizer>_codebook.npz``.

    The trainer returned carries ``stats``: ``vectors`` (trained),
    ``files_read`` (the files not yet processed, which this call reads),
    ``segments`` (the segments this call encodes: none that an earlier call
    trained), ``segments_trained`` (those of them that went through an
    update), ``wall_s`` and ``timers``: synchronised spans ``setup`` (the
    encoder's weights and the trainer's state), ``encode`` and ``update``."""
    from ..io.audio import find_audio_files
    from ..io.dataset import AudioSegmentStream, batched_segments

    t0 = time.perf_counter()
    os.makedirs(outdir, exist_ok=True)
    processed_path = os.path.join(outdir, "processed_files.json")
    processed, partial = set(), {}
    if os.path.exists(processed_path):
        with open(processed_path) as f:
            record = json.load(f)
        processed, partial = set(record["files"]), record.get("partial", {})

    timers = StageTimers(device)
    with timers.span("setup", sync=True):
        enc, cfg = _encoder(tokenizer, weights, device)
        trainer = EMAVQTrainer(VQTrainConfig(codebook_size=cfg.num_clusters,
                                             dim=cfg.hidden_dim), device=enc.device)
        ckpt = os.path.join(outdir, "quantizer_state.npz")
        if os.path.exists(ckpt):
            trainer.load(ckpt)
            logger.info("resumed quantizer at step %d", trainer.steps)

    # segments a file yields, from the producer threads once it is read
    lock = threading.Lock()
    emitted = {}

    def on_file_complete(name, n_segments):
        with lock:
            emitted[name] = n_segments

    seen = Counter()  # segments of each file taken into the buffer
    trained = Counter(partial)  # ... and through an update, in this call or before

    def save():
        with lock:
            done = {f for f, n in emitted.items() if trained[f] == n}
        trainer.save(ckpt)
        with open(processed_path, "w") as f:
            json.dump({"files": sorted(processed | done),
                       "partial": {f: n for f, n in sorted(trained.items())
                                   if n and f not in done}}, f)

    files = [f for f in find_audio_files(indir) if f not in processed]
    stream = AudioSegmentStream(files, cfg.model_sample_rate, cfg.model_token_rate, chunk_size,
                                transform=getattr(enc, "host_transform", None),
                                on_file_complete=on_file_complete, skip_segments=partial)
    buf, buf_n, vectors, segments = [], 0, 0, 0
    for audio, lengths, cfgs in batched_segments(stream, encode_batch, num_workers):
        with timers.span("encode", sync=True):
            feats, n_frames = enc.features(audio, lengths)  # [B, T', D] on the device
        for i, c in enumerate(cfgs):
            if c is None:
                continue  # a row that pads the last batch
            buf.append(feats[i, : min(n_frames, c.chunk_length_tokens)])
            buf_n += buf[-1].shape[0]
            seen[c.file_name] += 1
            segments += 1
        if buf_n >= batch_vectors:
            with timers.span("update", sync=True):
                metrics = trainer.update(torch.cat(buf))
            vectors += buf_n
            buf, buf_n = [], 0
            trained.update(seen)
            seen.clear()
            logger.info("step %d: commit %.4f active %.1f%%", trainer.steps,
                        metrics["commit_loss"], 100 * metrics["active_frac"])
            if trainer.steps % save_freq == 0:
                save()
            if max_steps and trainer.steps >= max_steps:
                break

    save()
    np.savez(os.path.join(outdir, f"{tokenizer}_codebook.npz"), codebook=trainer.codebook)
    trainer.stats = {"vectors": vectors, "files_read": len(files), "segments": segments,
                     "segments_trained": sum(trained.values()) - sum(partial.values()),
                     "wall_s": time.perf_counter() - t0, "timers": timers}
    logger.info("done at step %d", trainer.steps)
    return trainer


if __name__ == "__main__":
    from argparse import ArgumentParser

    p = ArgumentParser(description="Train a semantic quantizer codebook online")
    p.add_argument("--tokenizer", choices=["semantic_s", "semantic_m"], required=True)
    p.add_argument("--indir", required=True)
    p.add_argument("--outdir", required=True)
    p.add_argument("--batch_vectors", type=int, default=DEFAULT_BATCH_VECTORS)
    p.add_argument("--save_freq", type=int, default=100)
    p.add_argument("--weights", default="artifacts")
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--device", default="cuda")
    a = p.parse_args()
    train_quantizer(a.tokenizer, a.indir, a.outdir, batch_vectors=a.batch_vectors,
                    save_freq=a.save_freq, weights=a.weights, max_steps=a.max_steps,
                    device=a.device)
