"""The encoders: host <-> device boundary, bucketing, dtype policy.

Counterpart of ``audiotoken_tpu/encoders.py``: ``AcousticEncoder`` gives
numpy int16 codes [B, K, T] at 75 frames per second, ``HubertEncoder``
(semantic_s) and ``Wav2VecBertEncoder`` (semantic_m) int16 ids [B, 1, T]
at 50 per second.

Each encoder's ``dispatch`` queues the work on the device and returns the
device tensor without waiting for it (no copy back, no synchronisation):
the corpus executor (``runtime/executor.py``) overlaps the next batch's
host work with it. ``accepts_int16`` tells the executor that raw PCM16
may be sent; ``int16_device_transform`` that the host transform has a
device equivalent for int16 input.

Every encoder takes the JAX package's precision policies ("highest",
"high", "default", "bfloat16"; ``runtime/precision.py``) and ``buckets``,
a grid of padded lengths in samples (the default grid when None);
``Wav2VecBertEncoder`` also takes "mixed" and ``stage_overrides``.

Every encoder also takes ``mesh`` (``parallel/mesh.py:make_mesh``), data
parallel as in the JAX package: the weights are replicated on every rank,
each "dp" rank encodes its share of the rows with its own kernels, and
every rank returns the whole batch, gathered over "dp". Batches larger
than ``max_device_batch * dp`` run as sub-batches of that many rows, the
last one padded by repeating its first row; a batch within that bound must
be a multiple of dp (a ValueError, as JAX's ``device_put`` raises). All
ranks of the mesh make the same calls with the same batch.
"""

import math
from typing import Optional

import numpy as np
import torch

import torch.nn.functional as F

from .configs import AcousticEncoderConfig, HubertEncoderConfig, Wav2VecBertConfig
from .nn.conformer import W2VBertConfig, W2VBertFeatures
from .nn.fbank import FbankConfig, fbank_features
from .nn.hubert import HubertConfig, HubertFeatures, feature_lengths
from .nn.rvq import ResidualVQ, RVQConfig
from .nn.seanet import SeanetConfig, SeanetEncoder
from .ops.lookup import nearest_centroid
from .parallel.collectives import all_gather
from .parallel.mesh import check_mesh
from .parallel.shard import data_parallel_shardings
from .runtime.bucketing import default_buckets, pad_to_bucket
from .runtime.precision import (
    W2VBERT_MIXED_OVERRIDES,
    StagePrecision,
    get_policy,
    resolve_mixed,
)
from .weights import (
    acoustic_from_numpy,
    get_acoustic_params,
    get_hubert_params,
    get_w2vbert_params,
    hubert_from_numpy,
    w2vbert_from_numpy,
)


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device raises when no GPU is
    present rather than running elsewhere."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    return device


def mesh_device(device, mesh) -> torch.device:
    """The encoder's device: ``device``, or under a mesh the mesh's (the
    rank's card), which must be of ``device``'s type."""
    check_mesh(mesh)
    if mesh is None:
        return resolve_device(device)
    if torch.device(device).type != mesh.device.type:
        raise ValueError(f"device {str(device)!r} is not the mesh's {str(mesh.device)!r}")
    return resolve_device(mesh.device)


def _require_min_samples(n: int, min_samples: int, sample_rate: int, who: str):
    if n < min_samples:
        raise ValueError(
            f"{who}: input audio is {n} samples "
            f"({1000.0 * n / sample_rate:.1f} ms) — shorter than the "
            f"{1000.0 * min_samples / sample_rate:.1f} ms minimum "
            f"({min_samples} samples at {sample_rate} Hz) needed to produce "
            "one token"
        )


def _run_subbatched(forward, max_b: int, *xs: torch.Tensor) -> torch.Tensor:
    """``forward(*xs)`` in serial sub-batches of at most ``max_b`` rows,
    joined on the device. Every row is encoded independently of the others."""
    B = xs[0].shape[0]
    if B <= max_b:
        return forward(*xs)
    return torch.cat([forward(*(x[i : i + max_b] for x in xs)) for i in range(0, B, max_b)])


def _mask_to_lengths(attention_mask, audio_shape) -> np.ndarray:
    """Host side: an attention mask as [B] int32 lengths where it can be.

    None -> full lengths; [B] lengths pass through; a [B, T] mask becomes
    lengths only when it is a binary valid-prefix mask, and is returned
    whole (f32) otherwise."""
    if attention_mask is None:
        return np.full(audio_shape[0], audio_shape[-1], np.int32)
    m = np.asarray(attention_mask)
    if m.ndim == 1:
        return m.astype(np.int32)
    m = m.astype(np.float32, copy=False)
    binary = bool(((m == 0.0) | (m == 1.0)).all())
    if binary and bool(np.all(m[:, :-1] >= m[:, 1:])):
        return np.count_nonzero(m, axis=-1).astype(np.int32)
    return m


def _expand_mask(mask: torch.Tensor, T: int) -> torch.Tensor:
    """Device side: [B] lengths -> [B, T] f32 prefix mask; a [B, T] mask
    passes through."""
    if mask.ndim == 1:
        return (torch.arange(T, device=mask.device)[None, :] < mask[:, None]).float()
    return mask


def _h2d(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device`` without waiting for the device. On a CUDA
    device the array is staged in pinned memory and copied asynchronously,
    behind the work already queued on the stream, so the host goes on to
    queue the next batch (a copy from pageable memory would wait for the
    device first). The pinned block is not reused before the copy is done."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _run_rows(encoder, forward, *host: np.ndarray) -> torch.Tensor:
    """``forward`` over host arrays with rows first -> the device result for
    every row. Without a mesh the arrays go to the device whole and run in
    sub-batches of ``max_device_batch`` rows. Under a mesh each dp rank
    sends and encodes its share of every sub-batch of ``max_device_batch *
    dp`` rows, and the shares are gathered over dp."""
    mesh, dev = encoder.mesh, encoder.device
    if mesh is None:
        return _run_subbatched(forward, encoder.max_device_batch, *(_h2d(a, dev) for a in host))
    _, batch_spec = data_parallel_shardings(mesh)
    dp = mesh.axis(batch_spec[0])  # tp ranks of one dp group encode the same rows
    mb = encoder.max_device_batch * dp.size
    B = host[0].shape[0]
    if B <= mb and B % dp.size:
        raise ValueError(f"a batch of {B} rows does not split over dp = {dp.size} ranks: "
                         f"its size should be divisible by {dp.size}")
    outs = []
    for i in range(0, B, mb):
        chunk = [a[i:i + mb] for a in host]
        n = chunk[0].shape[0]
        if B > mb and n < mb:  # one sub-batch shape: repeat the first row
            chunk = [np.concatenate([c, np.repeat(c[:1], mb - n, axis=0)]) for c in chunk]
        rows = chunk[0].shape[0] // dp.size
        out = forward(*(_h2d(c[dp.index * rows:(dp.index + 1) * rows], dev) for c in chunk))
        # NCCL has no int16: the ids and codes are gathered as int32
        wide = out.int() if out.dtype == torch.int16 else out
        outs.append(all_gather(wide, dp, dim=0).to(out.dtype)[:n])
    return torch.cat(outs) if len(outs) > 1 else outs[0]


def _to_host(encoder, input_batch, attention_mask, who: str):
    """Host side of the semantic encoders: the batch as f32 or int16 PCM,
    its length checked against ``encoder._min_samples``, padded to a
    bucket, with its mask ([B] lengths where it can be) -> (audio, mask,
    samples per row)."""
    audio = np.asarray(input_batch)
    if audio.dtype != np.int16:
        audio = audio.astype(np.float32)
    n = audio.shape[-1]
    _require_min_samples(n, encoder._min_samples, encoder.config.model_sample_rate, who)
    padded = pad_to_bucket(audio, encoder.buckets, encoder.config.pad_token or 0)
    mask = _mask_to_lengths(attention_mask, audio.shape)
    if mask.ndim == 2:
        mask = np.pad(mask, ((0, 0), (0, padded.shape[-1] - mask.shape[-1])))
    return padded, mask, n


class AcousticEncoder:
    """Waveform -> EnCodec RVQ codes [B, num_codebooks, T] int16 at 75 fps.

    Takes float32 or raw int16 PCM; int16 is scaled by the exact 1/2^15 on
    the device."""

    accepts_int16 = True

    def __init__(
        self,
        config: AcousticEncoderConfig = AcousticEncoderConfig(),
        weights: str = "artifacts",
        precision: str = "highest",
        seed: int = 0,
        device="cuda",
        buckets=None,
        mesh=None,
    ):
        self.device = mesh_device(device, mesh)
        self.mesh = mesh
        self.config = config
        self.seanet_cfg = SeanetConfig()
        self.rvq_cfg = RVQConfig()
        self.num_q = self.rvq_cfg.num_quantizers_for_bandwidth(config.bandwidth)
        self.set_precision(precision)
        self.hop = self.seanet_cfg.hop_length  # 320 -> 75 fps at 24 kHz

        state, codebooks = acoustic_from_numpy(get_acoustic_params(weights, seed))
        self.seanet = SeanetEncoder(self.seanet_cfg)
        self.seanet.load_state_dict(state)
        self.seanet.to(self.device).eval()
        self.quantizer = ResidualVQ(codebooks, self.num_q).to(self.device)
        self.buckets = buckets or default_buckets(config.model_sample_rate, self.hop)
        # Larger batches run as sub-batches of this many rows; 32 x 30 s is
        # the batch the JAX package sized its device memory for.
        self.max_device_batch = 32

    def set_precision(self, precision: str):
        """Change the precision policy without loading the weights again."""
        self.policy = get_policy(precision)

    def _forward(self, audio: torch.Tensor) -> torch.Tensor:
        """[B, T] f32 or int16 on the device -> codes [B, num_q, T'] int16."""
        with torch.inference_mode(), self.policy.numerics():
            if audio.dtype == torch.int16:
                # /2^15 is exact, so int16 input gives the f32 path's tokens
                audio = audio.float() * (1.0 / 32768.0)
            z = self.seanet(audio.to(self.policy.compute_dtype))
            return self.quantizer(z).to(torch.int16)

    def dispatch(self, input_batch: np.ndarray, attention_mask=None):
        """Encode without waiting for the device -> (device codes
        [B, num_q, T_bucket] int16, n_frames): the first ``n_frames`` are
        the input's, the rest the bucket padding's.

        ``attention_mask`` is accepted for the encoders' common signature
        and not used: the path is causal, so a row's codes over its valid
        prefix do not depend on what follows it."""
        audio = np.asarray(input_batch)
        if audio.dtype != np.int16:
            audio = audio.astype(np.float32)
        n = audio.shape[-1]
        _require_min_samples(n, 1, self.config.model_sample_rate, "AcousticEncoder")
        padded = pad_to_bucket(audio, self.buckets, self.config.pad_token or 0)
        return _run_rows(self, self._forward, padded), math.ceil(n / self.hop)

    def __call__(self, input_batch: np.ndarray, attention_mask=None) -> np.ndarray:
        """[B, T] float32 (or int16 PCM) -> [B, num_q, ceil(T/hop)] int16."""
        codes, n_frames = self.dispatch(input_batch, attention_mask)
        return codes[:, :, :n_frames].cpu().numpy()


class HubertEncoder:
    """mHuBERT layer-11 features -> k-means-1000 ids [B, 1, T] int16 at 50
    per second (semantic_s).

    float32 input must be normalised per utterance on the host first
    (:meth:`host_transform`, as ``AudioToken.encode`` does). Raw int16 PCM
    at 16 kHz is normalised on the device instead: scaled by the exact
    1/2^15, then zero mean and unit variance over each row's valid samples.
    ``attn_impl`` picks the attention of the 11 layers: ``"flash"`` (kernel
    K4 in its no-rel form on a CUDA device, its plain version on the CPU)
    or ``"xla"`` (plain attention over materialised [B, 12, T, T] scores);
    None takes ``HubertConfig``'s default, the faster of the two on the
    H100 (PERF.md).
    """

    accepts_int16 = True
    int16_device_transform = True  # the masked per-row normalisation of _forward

    @staticmethod
    def host_transform(waveform: np.ndarray) -> np.ndarray:
        """Per-utterance zero-mean, unit-variance normalisation of float
        audio (the reference's Wav2Vec2FeatureExtractor), on the host."""
        waveform = np.asarray(waveform, np.float32)
        mu = waveform.mean(axis=-1, keepdims=True)
        var = waveform.var(axis=-1, keepdims=True)
        return (waveform - mu) / np.sqrt(var + 1e-7)

    def __init__(
        self,
        config: HubertEncoderConfig = HubertEncoderConfig(),
        weights: str = "artifacts",
        precision: str = "highest",
        seed: int = 0,
        device="cuda",
        quantize: bool = True,
        attn_impl: Optional[str] = None,
        buckets=None,
        mesh=None,
    ):
        self.device = mesh_device(device, mesh)
        self.mesh = mesh
        self.config = config
        self.set_precision(precision)
        self.quantize = quantize
        self.model_cfg = HubertConfig() if attn_impl is None else HubertConfig(attn_impl=attn_impl)

        params, centroids = get_hubert_params(weights, seed, config)
        state = hubert_from_numpy(params, config.output_layer)
        del params
        with torch.device("meta"):
            model = HubertFeatures(self.model_cfg, config.output_layer)
        model.load_state_dict(state, assign=True)
        self.model = model.to(self.device).eval().requires_grad_(False)
        self.centroids = torch.from_numpy(centroids).to(self.device)
        self.buckets = buckets or default_buckets(config.model_sample_rate, 320)
        # Larger batches run as sub-batches of this many rows; 32 x 30 s fits
        # the 80 GB card in both attention forms (PERF.md).
        self.max_device_batch = 32
        # the smallest input that gives one frame: the conv stack inverted
        # (400 samples = 25 ms)
        m = 1
        for k, s in zip(reversed(self.model_cfg.conv_kernel),
                        reversed(self.model_cfg.conv_stride)):
            m = (m - 1) * s + k
        self._min_samples = m

    def set_precision(self, precision: str):
        """Change the precision policy without loading the weights again."""
        self.policy = get_policy(precision)

    def _forward(self, audio: torch.Tensor, mask: torch.Tensor, quantize: bool) -> torch.Tensor:
        """[B, N] f32 (normalised) or int16 and a [B] lengths or [B, N] mask
        on the device -> ids [B, T'] int16, or features [B, T', 768] f32."""
        with torch.inference_mode(), self.policy.numerics():
            mask = _expand_mask(mask, audio.shape[-1])
            if audio.dtype == torch.int16:
                # masked per-row normalisation; /2^15 first, so that the 1e-7
                # eps acts in the host path's value domain
                a = audio.float() * (1.0 / 32768.0)
                n = mask.sum(dim=-1, keepdim=True).clamp_min(1.0)
                mu = (a * mask).sum(dim=-1, keepdim=True) / n
                var = ((a - mu).square() * mask).sum(dim=-1, keepdim=True) / n
                audio = (a - mu) / torch.sqrt(var + 1e-7) * mask
            # under "bfloat16" the first conv and its norm take bf16 input
            feats = self.model(audio.to(self.policy.compute_dtype), mask)
            if not quantize:
                return feats
            feats = F.layer_norm(feats, feats.shape[-1:], eps=1e-5)  # affine-free
            return nearest_centroid(feats, self.centroids).to(torch.int16)

    def _run(self, input_batch, attention_mask, quantize: bool):
        x, m, n = _to_host(self, input_batch, attention_mask, "HubertEncoder")
        out = _run_rows(self, lambda a, mk: self._forward(a, mk, quantize), x, m)
        return out, feature_lengths(n, self.model_cfg)

    def dispatch(self, input_batch: np.ndarray, attention_mask=None):
        """Encode without waiting for the device -> (device ids [B, T'],
        n_valid_frames).

        ``attention_mask`` may be [B] int lengths or a [B, T] mask: a
        valid-prefix mask is sent as lengths, any other mask whole."""
        return self._run(input_batch, attention_mask, quantize=True)

    def features(self, input_batch: np.ndarray, attention_mask=None):
        """Layer-11 features without quantising, left on the device and not
        waited for -> (features [B, T', 768] f32, n_valid_frames)."""
        return self._run(input_batch, attention_mask, quantize=False)

    def __call__(self, input_batch: np.ndarray, attention_mask=None) -> np.ndarray:
        """[B, T] float32 (normalised) or int16 PCM -> ids [B, 1, T'] int16,
        or, with ``quantize=False``, layer-11 features [B, T', 768] f32."""
        out, n_frames = self._run(input_batch, attention_mask, quantize=self.quantize)
        if not self.quantize:
            return out[:, :n_frames].cpu().numpy()
        return out[:, None, :n_frames].cpu().numpy()


class Wav2VecBertEncoder:
    """Fbank -> conformer layer 19 (of 21) -> VQ-2048 ids [B, 1, T] int16 at
    50 per second (semantic_m).

    Takes float32 or raw int16 PCM at 16 kHz; int16 is scaled by the exact
    1/2^15 on the device, in ``__call__`` as in ``dispatch``. On a CUDA
    device the attention of every block is kernel K4; on the CPU it is K4's
    plain version.
    """

    accepts_int16 = True

    def __init__(
        self,
        config: Wav2VecBertConfig = Wav2VecBertConfig(),
        weights: str = "artifacts",
        precision: str = "highest",
        seed: int = 0,
        device="cuda",
        quantize: bool = True,
        buckets=None,
        stage_overrides=None,
        mesh=None,
    ):
        self.device = mesh_device(device, mesh)
        self.mesh = mesh
        self.config = config
        self.set_precision(precision, stage_overrides)
        self.quantize = quantize
        self.fbank_cfg = FbankConfig()
        self.model_cfg = W2VBertConfig()

        params, codebook = get_w2vbert_params(weights, seed, config)
        state = w2vbert_from_numpy(params, config.output_layer)
        del params
        with torch.device("meta"):
            model = W2VBertFeatures(self.model_cfg, config.output_layer)
        model.load_state_dict(state, assign=True)
        self.model = model.to(self.device).eval().requires_grad_(False)
        self.codebook = torch.from_numpy(codebook).to(self.device)
        self.buckets = buckets or default_buckets(config.model_sample_rate, 320)
        # Larger batches run as sub-batches of this many rows: K4 keeps the
        # attention's memory linear in T, so 32 x 30 s fits.
        self.max_device_batch = 32
        # one 50 Hz token = 2 fbank frames: frame_length + hop_length
        # samples (560 = 35 ms)
        self._min_samples = self.fbank_cfg.frame_length + self.fbank_cfg.hop_length

    def set_precision(self, precision: str, stage_overrides=None):
        """Change the precision policy and the stage map without loading
        the weights again. "mixed" is "high" with the stages of
        ``W2VBERT_MIXED_OVERRIDES`` at "highest"; explicit
        ``stage_overrides`` win."""
        precision, stage_overrides = resolve_mixed(
            precision, stage_overrides, W2VBERT_MIXED_OVERRIDES)
        self.policy = get_policy(precision)
        # per-stage precision, passed down the forward (runtime/precision.py)
        self.stage_prec = StagePrecision(self.policy, stage_overrides)

    def _forward(self, audio: torch.Tensor, mask: torch.Tensor,
                 pad_to_multiple_of: int, quantize: bool) -> torch.Tensor:
        """[B, N] f32 or int16 and a [B] lengths or [B, N] mask on the
        device -> ids [B, T'] int16, or features [B, T', 1024] f32."""
        with torch.inference_mode(), self.policy.numerics():
            mask = _expand_mask(mask, audio.shape[-1])
            if audio.dtype == torch.int16:
                # /2^15 is exact, so int16 input gives the f32 path's tokens
                audio = audio.float() * (1.0 / 32768.0)
            P = self.stage_prec
            proc = fbank_features(audio, mask, self.fbank_cfg, pad_to_multiple_of,
                                  precision=P("fbank"))
            feats = self.model(proc["input_features"].to(self.policy.compute_dtype),
                               proc["attention_mask"], P)
            if not quantize:
                return feats
            feats = F.layer_norm(feats, feats.shape[-1:], eps=1e-5)  # affine-free
            with P.numerics("vq"):
                return nearest_centroid(feats, self.codebook).to(torch.int16)

    def _run(self, input_batch, attention_mask, pad_to_multiple_of: int, quantize: bool):
        x, m, n = _to_host(self, input_batch, attention_mask, "Wav2VecBertEncoder")
        # 50 tokens/s: one token per 2 fbank frames (hop 160 * stride 2)
        n_frames = (1 + (n - self.fbank_cfg.frame_length) // self.fbank_cfg.hop_length) // 2
        out = _run_rows(self, lambda a, mk: self._forward(a, mk, pad_to_multiple_of, quantize),
                        x, m)
        return out, n_frames

    def dispatch(self, input_batch: np.ndarray, attention_mask=None,
                 pad_to_multiple_of: int = 2):
        """Encode without waiting for the device -> (device ids [B, T'],
        n_valid_frames).

        ``attention_mask`` may be [B] int lengths or a [B, T] mask: a
        valid-prefix mask is sent as lengths, any other mask whole."""
        return self._run(input_batch, attention_mask, pad_to_multiple_of, quantize=True)

    def features(self, input_batch: np.ndarray, attention_mask=None,
                 pad_to_multiple_of: int = 2):
        """Conformer features without quantising, left on the device and not
        waited for -> (features [B, T', 1024] f32, n_valid_frames)."""
        return self._run(input_batch, attention_mask, pad_to_multiple_of, quantize=False)

    def __call__(self, input_batch: np.ndarray, attention_mask=None,
                 pad_to_multiple_of: int = 2) -> np.ndarray:
        """[B, T] float32 (or int16 PCM) -> ids [B, 1, T'] int16, or, with
        ``quantize=False``, conformer features [B, T', 1024] float32."""
        out, n_frames = self._run(input_batch, attention_mask, pad_to_multiple_of,
                                  quantize=self.quantize)
        if not self.quantize:
            return out[:, :n_frames].cpu().numpy()
        return out[:, None, :n_frames].cpu().numpy()
