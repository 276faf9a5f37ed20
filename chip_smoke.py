"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

  1. a CUDA device is present; print its name and power limit;
  2. build the hand-written kernels from ``audiotoken_tpu_torch/csrc``;
  3. each kernel against its plain PyTorch version at the main path's
     shapes, with max-abs differences (K1, K2), code agreement (K3) and
     both times (CUDA events, warm-up, median of several runs); K1 at B=8,
     1 and 32 x 30 s, with its bound (its three products in 3xTF32, conv_in
     as FMAs, and its bytes) and every multiply-add as an f32 FMA beside it;
     K2 at B=8 and B=32 x 2250 steps, each against its plain version and
     cuDNN's 2-layer ``nn.LSTM`` in the same run, with microseconds a step;
     K3 at B=8, 1 and 32 x 30 s, with its bounds in 3xTF32 and as f32 FMAs;
  3a. ``elu_pad`` (every SEANet conv's input after K1: residual add, ELU and
     causal reflect pad in one pass, ``csrc/elu_pad.cu``): its ELU against
     ATen's on all 2^32 floats and its bf16 add and ELU on all 2^32 pairs of
     bf16 values, then every launch of one acoustic encoder and one decoder
     forward at B=32 x 30 s (``ELU_PAD_LAUNCHES``: the transposed convs'
     trimmed views and the LSTM's transposed output as the forwards give
     them) bit for bit against its plain twin, each timed beside the twin
     with its bytes over 3.35 TB/s, and the encoder's two largest in bf16;
  4. the main path through the entry points a user calls: ``AudioToken``
     encode of WAV files (one of 90 s, in 30 s chunks), then
     ``AcousticEncoder`` at 8 and 32 x 30 s of int16 PCM, with real-time
     factors; every kernel must have launched during this phase, and
     ``elu_pad`` 11 times a forward;
  5. the golden gate: ``tests/goldens/battery_acoustic.npz`` (4 weight
     seeds x 12 cases) and ``api_acoustic.npz`` under the acoustic contract
     of ``scripts/verify_tpu_parity.py``;
  3b. K4 (rel-key flash attention) against its plain version at the
     semantic_m shape [8, 16, 1500, 64] with a padding mask, and in its
     no-rel form at [2, 12, 1500, 64];
  4b. the semantic_m main path: ``AudioToken(Tokenizers.semantic_m)``
     encode of WAV files (one of 90 s, in 30 s chunks), then
     ``Wav2VecBertEncoder`` at 8 and 32 x 30 s of int16 PCM, with
     real-time factors; K4 must launch 19 times per forward;
  5b. the semantic_m golden gate: ``battery_semantic_m.npz`` (4 seeds x 12
     cases) and ``api_semantic_m.npz`` under the semantic_m contract;
  3c. the decode kernels against their plain versions, bf16 and f32: K5
     (non-causal attention) at [8, 16, 1024, 64], with SDPA beside it (its
     f32 path is K4's 3xTF32 kernel, with that bound and the FMA bound), K6
     (decode attention) at B=8 and B=32 over a 1024-slot cache at slots
     1023, 640 and 256 (two calls must give the same bits), with SDPA over
     the cache and a mask of the attended slots beside it, and once at B=8
     as the decode step launches it (chained after decode_qkv), and K7
     (decode_qkv, decode_ffn, and decode_ffn_tp, decode_ffn's tensor-parallel
     entry, on a tp=2 rank's shard with the identity for its all-reduce);
     all three are timed with the device's queue
     filled first (``device_ms``): K6 and K7 take microseconds, less than
     their launch, and K5's tenth of a millisecond is not much more than its
     wrapper's host time. K7 in bf16 at B=8 and 32 is timed with its weights
     cold (``cold_ms``: the calls cycle through distinct weight sets larger
     together than the L2, as a 12-layer step does), beside its plain
     version and the unfused chain of PyTorch calls for the same function
     (``chain_ms``), and warm (decode_ffn_tp at B=8 and 32 on the shard);
  4c. the decode main paths: ``AudioToken(Tokenizers.acoustic).decode`` of
     30 s of codes and ``AcousticDecoder`` at 8 and 32 x 30 s (real-time
     factors, peak memory), then ``AudioToken(Tokenizers.semantic_m)
     .decode_batch`` of 8 sources of 250 ids at the defaults (bf16,
     sampled, 1024 new tokens), with wall time, real-time factor and AR
     tokens/s; K6 and each K7 entry launch 12 times per decode step, K5 24
     times per Bark-fine pass, and K2 runs in the acoustic decoder, and
     ``elu_pad`` 14 times a forward of it;
  4f. ``decode_batch(..., pipeline_batch=8)`` of 16 sources of 250 ids
     against two serial calls of 8 with the chunk seeds, in turns: AR
     tokens and fine codes equal in every run, the fine stage on a CUDA
     stream of its own when pipelined, and in each pipelined run K6 and
     each K7 entry launched 12 times per decode step and K5 24 times per
     fine pass; both walls and the waveforms' largest difference;
  5c. the decode golden gate at full width, f32 and ``highest``, against
     ``tests/torch_goldens/decode_semantic_m_s0.npz`` (made by the JAX
     package): greedy AR tokens, argmax fine codes, and the waveforms; the
     f32 fine stage once more at ``fine_precision="default"``, which must
     launch K5's one-pass form 24 times a pass and the 3-pass one never
     (its agreement with the golden printed);
  3d. K8 (the attention ablations: K5's bf16 kernel with one part taken
     out, ``csrc/flash_attention_bf16.cu``; ``full64`` is K5's own
     instantiation) with each instantiation's registers and spill from the
     ``-Xptxas -v`` log, against its plain twins at [16, 16, 1024, 64] bf16,
     each mode and tile, ``full64`` bit for bit equal to K5; then the K8
     path, the attention micro-profile of
     ``scripts/profile_attn_micro_torch.py``, printed one case per line with
     K5 beside ``full64`` and SDPA, and K5's own split into products and
     softmax;
  3e. K4 in its no-rel masked form at the HuBERT shape [8, 12, 1499, 64]
     against its plain version and against SDPA with the padding bias;
  3f. K4 on bf16 q, k, v (K5's bf16 kernel with K4's terms,
     ``csrc/flash_attention_bf16.cu``): the public op once with the rel
     term and a mask at [8, 16, 1500, 64] and once with the mask alone at
     [8, 12, 1499, 64], its launches counted over those two calls (no
     entry path reaches this form), then each against its plain version
     with both times, the bound in bf16 operations, and SDPA with the mask
     as a boolean ``attn_mask`` beside the mask-only form. E is drawn large
     enough that the plain version without the rel term, with the band
     shifted by one, or clamped one step inside either edge, lies at least
     ten times the gate away; the form with neither term at T = 1024 must
     launch K5 and not K4;
  3g. the one-pass form of K4 and K5's f32 path (``precision="default"``
     or ``"high"``: ``csrc/flash_attention_tf32.cu``, wgmma in one TF32
     pass; its registers and spill from the ``-Xptxas -v`` log and its
     dynamic shared memory printed first) at
     [8, 16, 1500, 64] with the rel term and a mask, [8, 12, 1499, 64]
     with the mask alone and [8, 16, 1024, 64] (K5): one launch each
     through the public op, counted apart from the 3-pass kernel's; each
     within ``ONEPASS_SHARE`` of the output's scale of its TF32 twin (the
     plain version's ``tf32=True``), its distance from the f32 twin
     printed; timed beside the 3-pass kernel, the twin and SDPA in f32 with
     the TF32 switches on (naming the backend it took), with its bound in
     one TF32 pass;
  4g. Mimi's encode path (``nn/mimi.py``, no JAX counterpart): every
     ``elu_pad`` launch of one B=32 x 30 s forward in its zero mode
     (``MIMI_ELU_PAD_LAUNCHES``) bit for bit against its plain twin, the
     window kernel at [32, 8, 750, 64] in a window of 250 within
     ``KERNEL_ATOL`` of its plain twin (SDPA given the band as a boolean
     ``attn_mask`` beside it), K3 at D = 256 (1 + 31 codebooks of 2048 x
     256 over 12,000 rows) by code agreement, each timed beside its twin
     with its bound; then ``AudioToken(Tokenizers.mimi)``'s encoder at 8
     and 32 x 30 s: 8 window launches, 2 of K3 and 14 of ``elu_pad`` a
     forward (counts zeroed just before), neither K1 nor K2, the RTFx and
     peak memory, and a profiled forward;
  4h. ``linear_3xtf32`` (``csrc/linear_3xtf32.cu``, the semantic_m
     conformer's linears at ``highest``) at each of the forward's five
     (K, N) shapes (``LINEAR_SHAPES``) over a B=8 x 30 s call's 11,992
     rows: its largest error against a float64 product at most
     ``LINEAR_ERR_RATIO`` times cuBLAS IEEE SGEMM's on the same inputs, its
     time beside its plain twin (three TF32 products of the split parts)
     and cuBLAS IEEE SGEMM (the yardstick, never called by the port), its
     bound (three TF32 passes at 495 TFLOP/s, bytes at 3.35 TB/s), and the
     forward's 191 launches summed; phase 4b requires 191 launches for
     every 19 of K4 (one conformer forward) over its entry points, and
     exactly 19 and 191 in one B=8 x 30 s forward with the counts zeroed
     just before it, the number the kernels line reports;
  4d. the semantic_s main path: ``AudioToken(Tokenizers.semantic_s)``
     encode of WAV files (one of 90 s, in 30 s chunks), then
     ``HubertEncoder`` at 8 and 32 x 30 s of int16 PCM in both attention
     forms (real-time factors, peak memory); K4 must launch 11 times per
     ``"flash"`` forward;
  5d. the semantic_s golden gate: ``battery_semantic_s.npz`` (4 seeds x 12
     cases, host-normalised over each row's valid prefix) and
     ``api_semantic_s.npz``;
  4e. the corpus path on the card: a corpus made from ``--seed`` (about 30
     minutes of 24 kHz PCM16 in 48 files of 5-95 s, two 44.1 kHz stereo
     files and a tar of three members) through
     ``AudioToken(Tokenizers.acoustic).encode_batch_files`` at B=8 and 32:
     every file written once, with tokens equal to ``AudioToken.encode(path,
     chunk_size=30)``, a rerun that writes nothing, the corpus RTFx beside
     phase 4's device RTFx, the executor's stage spans and the device's busy
     share of the wall (CUDA events around each dispatch; and once under
     ``torch.profiler``); then the same corpus at 16 kHz through
     ``AudioToken(Tokenizers.semantic_s)`` at B=8 on the int16
     passthrough, ids equal to the encoder's synchronous ``dispatch`` of the
     same batches; K1-K4 must launch during the phase;
  5e. the four ``_i16`` rows of the acoustic battery, each written as a
     PCM16 WAV cut to its own length, through ``encode_batch_files`` for
     every weight seed, against ``battery_acoustic.npz`` under the per-case
     acoustic contract.
  5f. the precision ladder (``scripts/precision_ladder_torch.py``), run
     after each tokenizer's golden phase (5, 5b, 5d) over that phase's
     encoders, one per weight seed, switched from mode to mode without
     drawing their weights again: acoustic and semantic_s under
     ``highest``, ``high``, ``default`` and ``bfloat16``, semantic_m also
     under ``mixed``; per seed the battery's worst exactness row, its probes
     and the cases below the per-case contract, and the device RTFx at B=8
     and 32 x 30 s of int16 PCM (median of 3 after a warm-up). It gates
     that every ``highest`` line equals what the golden phase read, and
     that ``mixed``'s lines equal ``highest``'s on every exactness row of
     every seed; the other modes are measured, not gated. K1-K3 (acoustic)
     and K4 (the semantic encoders) must launch during it, K4 in one TF32
     pass under ``high``, ``default`` and ``bfloat16`` and in 3xTF32 under
     ``highest`` and ``mixed`` (the other form not at all), and semantic_m's
     linears take ``linear_3xtf32`` under ``highest`` and ``mixed`` alone
     (semantic_s's never). Then seed 0's
     encoder built with ``buckets=`` one 12 s bucket must pad the
     battery's 8 s rows to it and give the ids that the default grid gives
     the rows padded to 12 s by hand.

  6a. the converters: an HF-named EnCodec 24 kHz checkpoint and an
     ``_orig_mod.`` nanoGPT one, built from the seed-0 random trees
     (:func:`encodec_state_dict`, :func:`nanogpt_state_dict`), staged in a
     temporary ``$AUDIOTOKEN_ARTIFACTS``; the battery through
     ``AudioToken(acoustic, weights="artifacts")`` and through ``cli
     convert`` -> ``weights=<dir>``: codes equal bit for bit, within the
     acoustic contract of phase 5's seed-0 codes, K1-K3 launched; every
     store written checked against the manifests, the GPT's tree equal to
     its source;
  6b. quantizer training: ``train_quantizer("semantic_m")`` over phase 4e's
     16 kHz corpus in 10 s segments (each in the 12 s bucket, T = 600 at
     K4) with ``batch_vectors`` 16,000, its vectors/s and the encoder's
     share of its wall; K4 launched, and held against its plain version at
     [8, 16, 600, 64] and [8, 16, 500, 64] with the padding mask (the
     kernels line's ``flash_attention_relkey_vq`` is the first); one EMA step
     on the card against the CPU's; a second call resumes at the saved step
     and reads only the files whose vectors were never trained; the trained
     codebook's cluster diagnostics;
  6c. GPT training: ``TrainStep`` on the full GPT (12 x 768, block 1024,
     vocab 53,376), B=8 x T=1024, 10 steps on one batch under ``default``
     (TF32): the loss falls; against the same steps under ``highest``, step
     1's loss within ``GPT_STEP1_ATOL``, every step's within
     ``GPT_LOSS_ATOL``, the parameters' change within ``GPT_UPDATE_REL``,
     and a bf16 forward outside one of the three;
     ms a step, tokens/s, peak memory; the trained model through
     ``gpt_to_numpy`` -> ``save_params`` -> ``weights=<dir>`` decodes the
     same greedy tokens as the model in memory, K6 and K7 launched.
  7. the mesh (``audiotoken_tpu_torch/parallel``): 7a, a world of one
     over NCCL through the entry points' ``mesh=``:
     ``AudioToken(acoustic, mesh=make_mesh(("dp",)))`` on the battery,
     codes equal to phase 5's seed 0, and semantic_m at B=8 x 30 s, ids
     equal to phase 4b's, each with its RTFx beside the same encoder's
     without the mesh; 7b, two ranks on the one card over gloo (NCCL
     refuses two ranks on one GPU; which collectives gloo takes on CUDA
     tensors is checked first): the dp=2 acoustic battery under the
     per-case contract with its count of codes that differ from world 1
     (printed, not gated: cuDNN may choose another algorithm at 6 rows),
     the tp=2 sampler (f32, ``highest``, greedy) on the prompts of
     ``tests/torch_goldens/decode_semantic_m_s0.npz`` gated as 5c's AR
     rows, and ``TrainStep`` at (dp 1, tp 2) and (dp 2, tp 1) on 6c's
     batch for ``MESH_TRAIN_STEPS`` steps under ``highest``, each loss
     within ``MESH_LOSS_ATOL`` of 6c's world-1 losses; 7c, the tp=2
     conformer on 2 x 30 s of semantic_m: features within
     ``MESH_FEATURE_ATOL`` of world 1, ids under the semantic_m contract; 7d, each rank's
     launches of K4, K6 and K7 (``decode_qkv`` on the rank's qkv rows,
     ``decode_ffn_tp`` on its shard of the out-projection and MLP, with
     the all-reduces between its calls), and, after that count, K7's
     ``decode_ffn_tp`` against its plain version with the same
     all-reduce at the sampler's shard shapes; shard shapes, and ms a
     step, tokens/s and RTFx of the two processes sharing one card, which
     are not a scaling figure; 7e, ``encode_batch_files`` of phase 4e's
     corpus on the world-1 mesh over NCCL (files bit-equal to 4e's B=8
     files) and on the dp=2 mesh of the two gloo ranks (rank 0 reads,
     broadcasts and writes; each file under the acoustic per-case contract
     of world 1's, the count of differing codes printed), K1-K3 launched
     in the world-1 run and on each gloo rank.

Every kernel entry carries ``bound_ms``, the least time the card could take
for the same work: the larger of its operations over the H100's peak for
their type (67 TFLOP/s f32 FMAs, 989 TFLOP/s bf16; K1's, K3's and K4's
f32-accurate products in 3xTF32, three passes at 495 TFLOP/s, with the FMA
bound beside it as ``bound_f32_ms``; the one-pass forms one pass at 495
TFLOP/s) and its bytes (each input read once,
each output written once) over 3.35 TB/s; ``bound_by`` says which.
``library_ms`` is one PyTorch call computing the same function where there
is one (timed here, never called by the port), else null.

The line before the last is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``.
"""

import argparse
import functools
import itertools
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "scripts"))

import precision_ladder_torch as ladder  # noqa: E402
import profile_attn_micro_torch as micro  # noqa: E402
import profile_corpus_torch as corpus  # noqa: E402
from profile_hubert_torch import _union_s  # noqa: E402
import verify_tpu_parity as parity  # noqa: E402  (numpy-only at import)
from golden_cases import CASE_NAMES, WEIGHT_SEEDS, api_clips, battery  # noqa: E402

from audiotoken_tpu_torch import AudioToken, Tokenizers  # noqa: E402
from audiotoken_tpu_torch import cli  # noqa: E402
from audiotoken_tpu_torch.configs import COMMONS  # noqa: E402
from audiotoken_tpu_torch.convert.manifest import validate_tree  # noqa: E402
from audiotoken_tpu_torch.convert.store import _flatten, load_params, save_params  # noqa: E402
from audiotoken_tpu_torch.decoders import (  # noqa: E402
    AcousticDecoder,
    Wav2VecBertDecoder,
    _module_from_state,
)
from audiotoken_tpu_torch.encoders import (  # noqa: E402
    AcousticEncoder,
    HubertEncoder,
    Wav2VecBertEncoder,
)
from audiotoken_tpu_torch.io import _native  # noqa: E402
from audiotoken_tpu_torch.io.wavfile import read_wav, write_wav  # noqa: E402
from audiotoken_tpu_torch.nn.bark_fine import BarkFineGenerator  # noqa: E402
from audiotoken_tpu_torch.nn.gpt import GPT, GPTConfig, GPTSampler  # noqa: E402
from audiotoken_tpu_torch.nn.hubert import feature_lengths  # noqa: E402
from audiotoken_tpu_torch.nn.mimi import MimiConfig  # noqa: E402
from audiotoken_tpu_torch.ops import _build  # noqa: E402
from audiotoken_tpu_torch.ops.attention import padding_bias  # noqa: E402
from audiotoken_tpu_torch.ops.attn_ablation import (  # noqa: E402
    CASES,
    attn_ablation,
    attn_ablation_plain,
)
from audiotoken_tpu_torch.ops.decode_attention import (  # noqa: E402
    decode_attention,
    decode_attention_plain,
)
from audiotoken_tpu_torch.ops.decode_step import (  # noqa: E402
    decode_ffn,
    decode_ffn_plain,
    decode_ffn_tp,
    decode_ffn_tp_plain,
    decode_qkv,
    decode_qkv_plain,
)
from audiotoken_tpu_torch.ops.elu_pad import elu_pad, elu_pad_plain  # noqa: E402
from audiotoken_tpu_torch.ops.elu_pad import elu_mismatches as elu_pad_mismatches  # noqa: E402
from audiotoken_tpu_torch.ops.flash_attention import (  # noqa: E402
    flash_attention_plain,
    flash_attention_relkey,
    flash_attention_relkey_bf16,
    flash_attention_relkey_plain,
    flash_attention_window,
    flash_attention_window_plain,
    noncausal_attention_plain,
)
from audiotoken_tpu_torch.ops.linear import linear_3xtf32, linear_3xtf32_twin  # noqa: E402
from audiotoken_tpu_torch.ops.lookup import nearest_centroid  # noqa: E402
from audiotoken_tpu_torch.ops.lstm import lstm_layer, lstm_layer_plain  # noqa: E402
from audiotoken_tpu_torch.ops.rvq import rvq_encode, rvq_encode_plain, rvq_plan  # noqa: E402
from audiotoken_tpu_torch.ops.seanet_front import (  # noqa: E402
    elu_mismatches,
    seanet_front,
    seanet_front_plain,
)
from audiotoken_tpu_torch.runtime import executor  # noqa: E402
from audiotoken_tpu_torch.runtime.precision import get_policy, tf32_numerics  # noqa: E402
from audiotoken_tpu_torch.train.cluster_diagnostics import compare_real_vs_random  # noqa: E402
from audiotoken_tpu_torch.train.gpt_train import TrainStep  # noqa: E402
from audiotoken_tpu_torch.train.vq_train import (  # noqa: E402
    VQTrainConfig,
    _ema_update,
    train_quantizer,
)
from audiotoken_tpu_torch.weights import (  # noqa: E402
    get_acoustic_params,
    get_semantic_gpt_params,
    gpt_from_numpy,
    gpt_to_numpy,
)

SR = 24_000
SR_M = 16_000  # semantic_m
KERNEL_ATOL = 1e-4  # K1, K2, K4: kernel vs plain in f32 (K4 in 3xTF32), other sum order
RVQ_AGREEMENT = 0.999  # K3: late-codebook near-ties may flip (RVQ contract)
ACOUSTIC_KERNELS = (seanet_front, lstm_layer, rvq_encode, elu_pad)
DECODE_KERNELS = (flash_attention_plain, decode_attention, decode_qkv, decode_ffn)
# decode_ffn_tp, K7's tensor-parallel entry, runs on phase 7's tp=2 sampler
# flash_attention_relkey_bf16, K4's bf16 form, runs on the public op's bf16 input (3f)
KERNELS = (ACOUSTIC_KERNELS + (flash_attention_relkey,) + DECODE_KERNELS
           + (decode_ffn_tp, flash_attention_relkey_bf16, flash_attention_window, linear_3xtf32))
W2V_BLOCKS = 19  # conformer blocks a semantic_m forward runs, one K4 launch each
# (K, N, launches a semantic_m forward) of the conformer's linears: q, k, v,
# out and pw2; the feature projection; pw1; each FFN's input; each FFN's output
LINEAR_SHAPES = ((1024, 1024, 5 * W2V_BLOCKS), (160, 1024, 1), (1024, 2048, W2V_BLOCKS),
                 (1024, 4096, 2 * W2V_BLOCKS), (4096, 1024, 2 * W2V_BLOCKS))
LINEAR_LAUNCHES = sum(n for _, _, n in LINEAR_SHAPES)  # 191
LINEAR_ROWS = 8 * 1499  # a B=8 x 30 s call's frames
# 4h: the 3xTF32 GEMM's largest error against float64, as a multiple of
# cuBLAS IEEE SGEMM's on the same inputs (0.2-0.3 at these shapes on the H100)
LINEAR_ERR_RATIO = 4
# Every elu_pad launch of one SEANet forward at B=32 x 30 s, in its order:
# (channels, samples, layout, (left, right), residual, elu, keep_input).
# layout: 0 a contiguous x; k > 0 a transposed conv's output with k samples
# trimmed off each row's right (rows of samples + k); None the LSTM's
# [B, T, C] output seen as [B, C, T].
ELU_PAD_LAUNCHES = {
    "encoder": [
        (32, 720000, 0, (2, 0), False, True, False),  # stage 1's down conv, after K1
        (64, 360000, 0, (2, 0), False, True, True),   # stage 2: conv1
        (32, 360000, 0, (0, 0), False, True, False),  # conv2
        (64, 360000, 0, (4, 0), True, True, False),   # down conv, the block's sum
        (128, 90000, 0, (2, 0), False, True, True),   # stage 3
        (64, 90000, 0, (0, 0), False, True, False),
        (128, 90000, 0, (5, 0), True, True, False),
        (256, 18000, 0, (2, 0), False, True, True),   # stage 4
        (128, 18000, 0, (0, 0), False, True, False),
        (256, 18000, 0, (8, 0), True, True, False),
        (512, 2250, 0, (6, 0), False, True, False),   # conv_out, after the LSTM
    ],
    "decoder": [
        (128, 2250, None, (6, 0), False, False, False),  # conv_in on the latents
        (512, 2250, 0, (0, 0), False, True, False),      # stage 1: the transposed conv
        (256, 18000, 8, (2, 0), False, True, True),      # conv1, on its trimmed output
        (128, 18000, 0, (0, 0), False, True, False),     # conv2
        (256, 18000, 0, (0, 0), True, True, False),      # stage 2: the block's sum
        (128, 90000, 5, (2, 0), False, True, True),
        (64, 90000, 0, (0, 0), False, True, False),
        (128, 90000, 0, (0, 0), True, True, False),      # stage 3
        (64, 360000, 4, (2, 0), False, True, True),
        (32, 360000, 0, (0, 0), False, True, False),
        (64, 360000, 0, (0, 0), True, True, False),      # stage 4
        (32, 720000, 2, (2, 0), False, True, True),
        (16, 720000, 0, (0, 0), False, True, False),
        (32, 720000, 0, (6, 0), True, True, False),      # conv_out
    ],
}
# Every elu_pad launch of one Mimi forward at B=32 x 30 s (4g), in its
# order and in ELU_PAD_LAUNCHES's form; every one pads zeros
# (pad_mode="constant") on a contiguous x
MIMI_ELU_PAD_LAUNCHES = [
    (1, 720000, 0, (6, 0), False, False, False),   # conv_in on the waveform
    (64, 720000, 0, (2, 0), False, True, True),    # stage 1: conv1
    (32, 720000, 0, (0, 0), False, True, False),   # conv2
    (64, 720000, 0, (4, 0), True, True, False),    # down conv, the block's sum
    (128, 180000, 0, (2, 0), False, True, True),   # stage 2
    (64, 180000, 0, (0, 0), False, True, False),
    (128, 180000, 0, (5, 0), True, True, False),
    (256, 36000, 0, (2, 0), False, True, True),    # stage 3
    (128, 36000, 0, (0, 0), False, True, False),
    (256, 36000, 0, (6, 0), True, True, False),
    (512, 6000, 0, (2, 0), False, True, True),     # stage 4
    (256, 6000, 0, (0, 0), False, True, False),
    (512, 6000, 0, (8, 0), True, True, False),
    (1024, 750, 0, (2, 0), False, True, False),    # conv_out
]
MIMI_RVQ_LAUNCHES = 2  # K3 a Mimi forward: the semantic codebook, then the 31 acoustic
HUBERT_LAYERS = 11  # layers a semantic_s forward runs, one K4 launch each ("flash")
GPT_LAYERS, FINE_LAYERS = 12, 24  # K6/K7 launches per decode step, K5 per fine pass
PIPE_NEW_TOKENS = 512  # 4f's AR tokens a row: half the default, to keep the script's time
# bf16 kernel vs plain version: both accumulate in f32 and round at the same
# points, so they differ by about one bf16 unit of the output's scale
BF16_SHARE = 2**-6
# K5 in bf16: kernel and plain version both round p to bf16 before the value
# product (the kernel against its running maximum), so they differ by at most
# a bf16 unit of the output's scale
K5_SHARE = 2**-7
REL_SENSITIVITY = 10  # 3f: a wrong rel term must move the output this many gates
# 3g: the one-pass kernel against its TF32 twin, which rounds at the kernel's
# points (q, k, E, p against the running maximum of its key tiles, v); they
# differ by f32 sums in another order, and where a p lands on the other side
# of a rounding boundary after an f32-level difference in its score, which
# moves an output by at most 2^-10 p |v| / l
ONEPASS_SHARE = 2**-12
#: the precision modes whose K4 runs in one TF32 pass (5f's gate)
ONEPASS_MODES = ("high", "default", "bfloat16")
GOLDEN_MARGIN = 1e-4  # a greedy AR step whose top-1/top-2 logit gap is below may flip
# H100 SXM peaks (NVIDIA's data sheet, dense): f32 outside the tensor cores,
# bf16 and TF32 tensor cores, and HBM3
PEAK_FLOPS = {"f32": 67e12, "bf16": 989e12, "tf32": 495e12}
HBM_BYTES_PER_S = 3.35e12
L2_BYTES = 50 * 2**20  # K7 is timed with weight sets that together exceed it


def say(*args):
    print(*args, flush=True)


def reset_counts():
    """Every kernel's launch count to 0, just before a main path runs."""
    for kern in KERNELS:
        kern.launches = 0
    for kern in (flash_attention_relkey, flash_attention_plain):  # their one-pass forms
        kern.launches_1pass = 0
    attn_ablation.launches.clear()


def cuda_ms(fn, warmup=2, reps=5):
    """Median device time of ``fn`` in ms (CUDA events around each call)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, n=20, warmup=2):
    """Device time of one ``fn`` in ms, for kernels shorter than their
    launch: the device first sleeps while the host queues ``n`` calls, so
    the events around them see device time only, not the host's."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)  # ~10 ms of the device's clock
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def cold_ms(fns, n=60):
    """:func:`device_ms` of calls that cycle through ``fns``, each of which
    reads its own weights: with more distinct weights than the L2 holds,
    every call reads them cold from device memory, as a 12-layer decode
    step does."""
    calls = itertools.cycle(fns)
    return device_ms(lambda: next(calls)(), n=n)


def _profiled(fn):
    """One call of ``fn`` under ``torch.profiler`` -> (its wall in s,
    synchronised; the device's events)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return wall, [e for e in prof.events() if e.device_type.name == "CUDA"]


def _device_time_by_name(events):
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.end - e.time_range.start
    return by_name


def top_kernel(fn):
    """The device kernel that takes most of one call of ``fn``, by name:
    which backend a library call took."""
    by_name = _device_time_by_name(_profiled(fn)[1])
    return max(by_name, key=by_name.get) if by_name else "no device kernel"


def device_split(fn, top=6):
    """One call of ``fn`` under ``torch.profiler``: a line with its wall
    time (synchronised), the device's busy time (the union of the kernels'
    spans: side streams may overlap) and idle share, and the ``top`` kernels
    by device time, summed by name."""
    wall, events = _profiled(fn)
    busy = _union_s([(e.time_range.start, e.time_range.end) for e in events])
    by_name = _device_time_by_name(events)
    kernels = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return (f"wall {wall * 1e3:.1f} ms under the profiler, device busy {busy * 1e3:.1f} ms "
            f"(idle {100 * (1 - busy / wall):.1f} %); by device time: "
            + "; ".join(f"{name[:60]} {us / 1e3:.1f} ms" for name, us in kernels))


def bound(flops, nbytes, kind):
    """{"bound_ms", "bound_by"}: the larger of ``flops`` at the card's peak
    for ``kind`` and ``nbytes`` at its memory rate. ``kind`` is "f32" (FMAs),
    "bf16" (tensor cores), "tf32" (one TF32 pass on the tensor cores) or
    "tf32x3": f32-accurate products in split precision on the tensor cores,
    three TF32 passes per operation."""
    t_ops = (3 * flops / PEAK_FLOPS["tf32"] if kind == "tf32x3"
             else flops / PEAK_FLOPS[kind]) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def phase1_device():
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this check runs on an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    say(smi)  # the card's name and power limit, as nvidia-smi gives them
    say(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")


def phase2_build():
    t0 = time.perf_counter()
    _build.library()
    say(f"[2] kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line or "build seconds" in line:
            say(f"[2]   {line.strip()}")
    # the host's libav decoder, for non-WAV input; no phase depends on it
    built = _native.native_available()
    say(f"[2] native libav decoder: {'built' if built else 'NOT built'} "
        f"({_native.library_path() if built else _native.build_log_path()})")


def _k1_bound(front_w, B, T):
    """K1's bound at [B, T] (ops/seanet_front.py WEIGHT_SHAPES): the largest of
    the k3 conv, conv2 and shortcut products in 3xTF32, conv_in's FMAs, and
    the bytes (x in, [B, 32, T] f32 out, the weights); and, beside it, every
    multiply-add as an f32 FMA (``bound_f32_ms``). A multiply-add per weight
    per sample, bias and ELU aside."""
    wc, _bc, w1, _b1, w2, _b2, ws, _bs = front_w
    products = 2 * (w1.numel() + w2.numel() + ws.numel()) * B * T
    conv_in = 2 * wc.numel() * B * T
    moved = 4 * B * T + 4 * B * 32 * T + nbytes(*front_w)
    parts = {"operations": max(bound(products, 0, "tf32x3")["bound_ms"],
                               bound(conv_in, 0, "f32")["bound_ms"]),
             "bytes": bound(0, moved, "f32")["bound_ms"]}
    by = max(parts, key=parts.get)
    return {"bound_ms": parts[by], "bound_by": by,
            "bound_f32_ms": bound(products + conv_in, moved, "f32")["bound_ms"]}


def phase3_kernels(dev):
    """Kernel vs plain version at the main path's shapes (8 x 30 s)."""
    enc = AcousticEncoder(weights="random", seed=0, device=dev)
    front_w = enc.seanet.front_weights()
    rng = np.random.default_rng(0)
    t = np.arange(30 * SR) / SR
    audio = np.stack([
        0.3 * np.sin(2 * np.pi * (110 + 40 * b) * t) * (0.6 + 0.4 * np.sin(2 * np.pi * 3 * t))
        + 0.03 * rng.standard_normal(t.shape)
        for b in range(8)
    ]).astype(np.float32)
    x = torch.from_numpy(audio).to(dev)
    res = {}

    # K1's ELU is expm1f's arithmetic on other instructions: the same bits
    elu_bad = elu_mismatches(dev)
    say(f"[3] K1's ELU against expm1f, bit for bit on all 2^32 floats: {elu_bad} differ")
    if elu_bad:
        raise AssertionError(f"K1's ELU differs from expm1f on {elu_bad} floats")
    # K1 at B=8 (the main path's shape, which the kernels line reports), then
    # B=1 and B=32 (the B=8 rows four times over)
    for B, xb in ((8, x), (1, x[:1]), (32, x.repeat(4, 1))):
        out = seanet_front(xb, *front_w)
        ref = seanet_front_plain(xb, *front_w)
        err = (out - ref).abs().max().item()
        del out, ref
        ms = cuda_ms(lambda: seanet_front(xb, *front_w), reps=9)
        plain_ms = cuda_ms(lambda: seanet_front_plain(xb, *front_w))
        b = _k1_bound(front_w, B, xb.shape[1])
        say(f"[3] K1 seanet_front [{B}, 720000]: max|kernel-plain| {err:.3e}  kernel {ms:.3f} ms"
            f"  plain {plain_ms:.3f} ms  bound {b['bound_ms']:.4f} ms ({b['bound_by']}; "
            f"products in 3xTF32, conv_in as FMAs), {b['bound_f32_ms']:.4f} ms as f32 FMAs")
        if not err <= KERNEL_ATOL:
            raise AssertionError(f"K1 differs from its plain version by {err} at B={B}")
        if B == 8:
            res["seanet_front"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                       library_ms=None, elu_mismatches=elu_bad, **b)
        else:
            r = res["seanet_front"]
            r["max_abs_err"] = max(r["max_abs_err"], err)
            r.update({f"ms_b{B}": ms, f"plain_ms_b{B}": plain_ms,
                      f"bound_ms_b{B}": b["bound_ms"], f"bound_f32_ms_b{B}": b["bound_f32_ms"]})
        del xb
    torch.cuda.empty_cache()

    # K2: both layers of the encoder's LSTM at T'=2250, H=512, at B=8 (the
    # main path's shape, which the kernels line reports) and B=32 (one row
    # group of a launch); each layer's kernel and plain version get the same
    # xi. The library yardstick is cuDNN's 2-layer LSTM on the same weights,
    # which also computes the input projections that K2 leaves to a matmul.
    lib = torch.nn.LSTM(512, 512, num_layers=2, batch_first=True).to(dev)
    with torch.inference_mode():
        for i, layer in enumerate(enc.seanet.lstm):
            for name, w in (("weight_ih", layer.wih), ("weight_hh", layer.whh),
                            ("bias_ih", layer.bih), ("bias_hh", layer.bhh)):
                getattr(lib, f"{name}_l{i}").copy_(w)
    steps = 2 * 2250  # two layers of 2250 steps
    for B in (8, 32):
        h = torch.from_numpy(rng.standard_normal((B, 2250, 512)).astype(np.float32)).to(dev)
        h_in = h
        err, ms, plain_ms, flops, moved = 0.0, 0.0, 0.0, 0, 0
        for layer in enc.seanet.lstm:
            xi = torch.matmul(h, layer.wih.t()) + (layer.bih + layer.bhh)
            out = lstm_layer(xi, layer.whh)
            ref = lstm_layer_plain(xi, layer.whh)
            err = max(err, (out - ref).abs().max().item())
            del ref
            ms += cuda_ms(lambda: lstm_layer(xi, layer.whh))
            plain_ms += cuda_ms(lambda: lstm_layer_plain(xi, layer.whh), warmup=1, reps=3)
            flops += 2 * xi.numel() * layer.whh.shape[1]  # h @ Whh^T at every step
            moved += nbytes(xi, layer.whh, out)
            h = out
        with torch.inference_mode():
            lib_err = (lib(h_in)[0] - h).abs().max().item()
            library_ms = cuda_ms(lambda: lib(h_in))
        say(f"[3] K2 lstm 2 layers [{B}, 2250, 512]: max|kernel-plain| {err:.3e}  "
            f"kernel {ms:.3f} ms ({ms * 1e3 / steps:.2f} us a step)  plain {plain_ms:.3f} ms  "
            f"torch.nn.LSTM (cuDNN) {library_ms:.3f} ms ({library_ms * 1e3 / steps:.2f} us a "
            f"step; kernel/cuDNN {ms / library_ms:.3f}) (max|kernel-cuDNN| {lib_err:.3e})")
        if not err <= KERNEL_ATOL:
            raise AssertionError(f"K2 differs from its plain version by {err} at B={B}")
        if B == 8:
            # the roofline ignores the step-to-step dependency of the recurrence
            res["lstm"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                               **bound(flops, moved, "f32"))
        else:
            b32 = bound(flops, moved, "f32")
            res["lstm"].update(max_abs_err=max(err, res["lstm"]["max_abs_err"]), ms_b32=ms,
                               plain_ms_b32=plain_ms, library_ms_b32=library_ms,
                               bound_ms_b32=b32["bound_ms"])
        del h, h_in, xi, out
    del lib

    # K3 on the latents of real SEANet output for the same audio: B=8 (the
    # main path's shape, which the kernels line reports), then B=1 and B=32
    # (the B=8 latents four times over: the same work as 32 rows)
    with torch.inference_mode():
        z8 = enc.seanet(x).float().contiguous()
    cb = enc.quantizer.codebooks
    recon = lambda c: sum(cb[k][c[:, k]] for k in range(16))  # noqa: E731
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for B, z in ((8, z8), (1, z8[:1].contiguous()), (32, z8.repeat(4, 1, 1))):
        split = rvq_plan(B * 2250, sms)  # blocks a cluster that split the codewords
        out = rvq_encode(cb, z, 16)
        ref = rvq_encode_plain(cb, z, 16)
        agree = (out == ref).float().mean().item()
        err = (recon(out.long()) - recon(ref.long())).abs().max().item()
        ms = cuda_ms(lambda: rvq_encode(cb, z, 16))
        plain_ms = cuda_ms(lambda: rvq_encode_plain(cb, z, 16))
        # every frame's residual against every entry of each of the 16 codebooks,
        # f32-accurate: in 3xTF32 on the tensor cores, and as f32 FMAs beside it
        flops, moved = 2 * z.numel() * 16 * cb.shape[1], nbytes(z, cb[:16], out)
        b, b32 = bound(flops, moved, "tf32x3"), bound(flops, moved, "f32")["bound_ms"]
        say(f"[3] K3 rvq 16 x 1024 x 128 over [{B}, 2250, 128] (split {split}): "
            f"code agreement {agree:.6f}  max|recon diff| {err:.3e}  kernel {ms:.3f} ms  plain "
            f"{plain_ms:.3f} ms  bound {b['bound_ms']:.3f} ms in 3xTF32 ({b['bound_by']}), "
            f"{b32:.3f} ms as f32 FMAs")
        if not agree >= RVQ_AGREEMENT:
            raise AssertionError(f"K3 codes agree with its plain version at {agree} at B={B}")
        if B == 8:
            res["rvq"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                              agreement=agree, **b, bound_f32_ms=b32)
        else:
            res["rvq"].update({f"ms_b{B}": ms, f"plain_ms_b{B}": plain_ms,
                               f"bound_ms_b{B}": b["bound_ms"], f"bound_f32_ms_b{B}": b32,
                               f"agreement_b{B}": agree})
    return res


def _elu_pad_input(dev, B, C, T, layout, dtype, seed):
    """x [B, C, T] of ``dtype`` in an ``ELU_PAD_LAUNCHES`` layout, from ``seed``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if layout is None:
        return torch.randn((B, T, C), generator=g, device=dev).to(dtype).transpose(1, 2)
    return torch.randn((B, C, T + layout), generator=g, device=dev).to(dtype)[..., :T]


def phase3a_elu_pad(dev, B=32):
    """elu_pad against ATen on every input of its ELU (and bf16 add), then
    every launch of one acoustic encoder and one decoder forward at
    ``B`` x 30 s, in f32 and in bf16, bit for bit against its plain twin
    and timed beside it, with its bytes (x and the residual read once, out
    and the kept input written once) over 3.35 TB/s. The kernels line
    reports the f32 forms: ``ms``, ``plain_ms`` and ``bound_ms`` of the
    encoder's largest launch, ``*_decoder`` of the decoder's, and
    ``*_forward_encoder`` / ``*_forward_decoder`` summed over a forward."""
    f32, bf16 = torch.float32, torch.bfloat16
    bad = {dt: elu_pad_mismatches(dev, dt) for dt in (f32, bf16)}
    say(f"[3a] elu_pad against ATen, bit for bit: its ELU on all 2^32 floats, {bad[f32]} "
        f"differ; its bf16 add and ELU on all 2^32 pairs of bf16 values, {bad[bf16]} differ")
    if any(bad.values()):
        raise AssertionError(f"elu_pad differs from ATen on {bad[f32]} floats and "
                             f"{bad[bf16]} bf16 pairs")
    res = {"max_abs_err": 0.0, "library_ms": None, "elu_mismatches": bad[f32],
           "elu_mismatches_bf16": bad[bf16]}
    for dt, tag in ((f32, ""), (bf16, "_bf16")):
        for model, launches in ELU_PAD_LAUNCHES.items():
            say(f"[3a] elu_pad {tag[1:] or 'f32'}: every launch of one acoustic {model} forward "
                f"at B={B}: shape, pads, residual, elu, keep written; GB, kernel ms, share of "
                f"3.35 TB/s, twin ms")
            total = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bytes": 0}
            largest = None
            for i, (C, T, layout, (left, right), has_res, elu, keep) in enumerate(launches):
                x = _elu_pad_input(dev, B, C, T, layout, dt, 2 * i)
                r = _elu_pad_input(dev, B, C, T, 0, dt, 2 * i + 1) if has_res else None
                n0 = elu_pad.launches
                out = elu_pad(x, left, right, residual=r, elu=elu, keep_input=True)
                ref = elu_pad_plain(x, left, right, r, elu, keep_input=True)
                torch.cuda.synchronize()
                if elu_pad.launches != n0 + 1:
                    raise AssertionError(f"elu_pad launched {elu_pad.launches - n0} times")
                if not (torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])):
                    raise AssertionError(f"elu_pad {dt} differs from its twin at {model} "
                                         f"launch {i}: [{B}, {C}, {T}], pads ({left}, {right})")
                written = keep and out[1] is not x
                moved = x.element_size() * B * C * (T * (1 + has_res + written) + T + left
                                                    + right)
                del out, ref
                ms = cuda_ms(lambda: elu_pad(x, left, right, r, elu, keep))
                plain_ms = cuda_ms(lambda: elu_pad_plain(x, left, right, r, elu, keep))
                b = bound(0, moved, "f32")
                say(f"[3a]   {str([B, C, T]):16s} ({left}, {right}) {int(has_res)} {int(elu)} "
                    f"{int(written)}{' strided' if layout != 0 else ''}: {moved / 1e9:.3f} GB  "
                    f"kernel {ms:.4f} ms  {100 * b['bound_ms'] / ms:.1f} %  twin {plain_ms:.4f} ms")
                for k, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", b["bound_ms"]),
                             ("bytes", moved)):
                    total[k] += v
                if largest is None or moved >= largest[3]:
                    largest = (ms, plain_ms, b, moved)
                del x, r
            ms, plain_ms, b, moved = largest
            say(f"[3a] elu_pad {tag[1:] or 'f32'} {model}: largest launch {moved / 1e9:.3f} GB in "
                f"{ms:.4f} ms ({100 * b['bound_ms'] / ms:.1f} % of 3.35 TB/s, twin "
                f"{plain_ms:.4f} ms); the forward's {len(launches)} launches "
                f"{total['bytes'] / 1e9:.3f} GB in {total['ms']:.4f} ms "
                f"({100 * total['bound_ms'] / total['ms']:.1f} %, twin {total['plain_ms']:.4f} ms)")
            if model == "encoder" and dt == f32:
                res.update(ms=ms, plain_ms=plain_ms, **b)
            else:
                res.update({f"ms_{model}{tag}": ms, f"plain_ms_{model}{tag}": plain_ms,
                            f"bound_ms_{model}{tag}": b["bound_ms"]})
            res.update({f"{k}_forward_{model}{tag}": total[k]
                        for k in ("ms", "plain_ms", "bound_ms")})
    torch.cuda.empty_cache()
    return {"elu_pad": res}


def _check_codes(codes, shape):
    if codes.shape != shape or codes.dtype != np.int16:
        raise AssertionError(f"codes {codes.shape} {codes.dtype}, expected {shape} int16")
    if codes.min() < 0 or codes.max() >= 1024:
        raise AssertionError(f"codes outside [0, 1024): {codes.min()}..{codes.max()}")


def phase4_main_path(dev, tmp):
    """The user-facing entry points; returns each kernel's launch count and
    the encoder's device RTFx at B=8 and 32."""
    rng = np.random.default_rng(7)
    clip90 = (0.2 * rng.standard_normal(90 * SR)).astype(np.float32)
    clip7 = (0.2 * rng.standard_normal(7 * SR + 123)).astype(np.float32)
    pcm30 = (rng.standard_normal((32, 30 * SR)) * 3000).clip(-32768, 32767).astype(np.int16)
    for name, clip in (("clip90.wav", clip90), ("clip7.wav", clip7)):
        write_wav(os.path.join(tmp, name), clip[None], SR)
    at = AudioToken(Tokenizers.acoustic, num_codebooks=16, weights="random", device=dev)
    at.load_encoder()
    enc = at.encoder
    enc(pcm30[:8])  # warm up cuDNN's algorithm choice and the allocator
    torch.cuda.synchronize()

    reset_counts()
    toks = at.encode(os.path.join(tmp, "clip7.wav"))
    _check_codes(toks, (1, 16, -(-(7 * SR + 123) // 320)))
    toks = at.encode(os.path.join(tmp, "clip90.wav"), chunk_size=30)
    _check_codes(toks, (1, 16, 6750))
    rtfx = {}
    for B in (8, 32):
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            codes = enc(pcm30[:B])
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            _check_codes(codes, (B, 16, 2250))
        wall = statistics.median(walls)
        rtfx[B] = B * 30.0 / wall
        say(f"[4] AcousticEncoder B={B} x 30 s int16: median wall {wall * 1e3:.1f} ms "
            f"(runs {', '.join(f'{w * 1e3:.1f}' for w in walls)}), RTFx {rtfx[B]:.1f}")
    say(f"[4] AcousticEncoder B=8 profiled: {device_split(lambda: enc(pcm30[:8]))}")
    counts = {k.__name__: k.launches for k in ACOUSTIC_KERNELS}
    say(f"[4] kernel launches during the main path: {counts}")
    for name, n in counts.items():
        if n < 1:
            raise AssertionError(f"kernel {name} was not launched by the main path")
    _check_elu_pad_launches("[4]", "encoder", lambda B: enc(pcm30[:B]))
    return counts, rtfx


def _check_elu_pad_launches(tag, model, forward):
    """One forward at B=8 and one at 32, each with elu_pad's count reset
    just before: one launch for each entry of ``ELU_PAD_LAUNCHES[model]``."""
    want = len(ELU_PAD_LAUNCHES[model])
    for B in (8, 32):
        elu_pad.launches = 0
        forward(B)
        if elu_pad.launches != want:
            raise AssertionError(f"elu_pad launched {elu_pad.launches} times in an acoustic "
                                 f"{model} forward at B={B}, expected {want}")
    say(f"{tag} elu_pad: {want} launches an acoustic {model} forward at B=8 and at 32")


def phase5_goldens(dev, tmp, keep):
    """The acoustic golden gate; returns the seed-0 battery codes. ``keep``
    gets each seed's encoder and battery line (for phase 5f)."""
    g = np.load(os.path.join(parity.GOLD, "battery_acoustic.npz"))
    audio, _lengths, names = battery(SR)
    failures = []
    for seed in WEIGHT_SEEDS:
        enc = keep.setdefault("encs", {})[seed] = AcousticEncoder(
            weights="random", seed=seed, device=dev)
        ids = enc(audio)
        if seed == 0:
            ids_s0 = ids
        ref = g[f"ids_s{seed}"]
        per_case = (ids.reshape(len(names), -1) == ref.reshape(len(names), -1)).mean(axis=1)
        keep.setdefault("lines", {})[seed] = per_case
        for name, agree in zip(names, per_case):
            thresh = parity.case_thresh("acoustic", name)
            ok = agree >= thresh
            say(f"[5] battery s{seed:<2d} {name:14s} agreement {agree:.6f} "
                f"(>= {thresh}) {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"s{seed} {name} {agree:.6f}")

    g = np.load(os.path.join(parity.GOLD, "api_acoustic.npz"))
    at = AudioToken(Tokenizers.acoustic, num_codebooks=16, weights="random", device=dev)
    at.load_encoder()
    for name, wav in api_clips(SR, at.encoder.buckets).items():
        if name == "multichunk_90s":
            path = os.path.join(tmp, "api90.wav")
            write_wav(path, (np.clip(wav, -1, 1) * 32767.0).astype(np.int16)[None], SR)
            toks = at.encode(path, chunk_size=30.0)
        else:
            toks = at.encode(wav[None].astype(np.float32))
        ref = g[f"tokens_{name}"]
        agree = float((toks == ref).mean()) if toks.shape == ref.shape else 0.0
        ok = agree >= parity.ACOUSTIC_THRESH
        say(f"[5] api {name:14s} agreement {agree:.6f} (>= {parity.ACOUSTIC_THRESH}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"api {name} {agree:.6f}")
    if failures:
        raise AssertionError("golden gate failed: " + "; ".join(failures))
    return ids_s0


def phase3b_flash_attention(dev):
    """K4 against its plain version: the semantic_m shape with a padding
    mask that cuts two rows short, and the no-rel form (HuBERT's shape)."""
    rng = np.random.default_rng(3)

    def t(shape, scale):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)

    B, H, T = 8, 16, 1500
    q, k, v = t((B, H, T, 64), 0.3), t((B, H, T, 64), 0.3), t((B, H, T, 64), 1.0)
    E = t((73, 64), 0.02)
    mask = torch.ones((B, T), device=dev)
    mask[1, T - 377:] = 0.0
    mask[5, T // 2:] = 0.0
    out = flash_attention_relkey(q, k, v, E, mask)
    err = (out - flash_attention_relkey_plain(q, k, v, E, mask)).abs().max().item()
    del out
    ms = cuda_ms(lambda: flash_attention_relkey(q, k, v, E, mask), reps=9)
    plain_ms = cuda_ms(lambda: flash_attention_relkey_plain(q, k, v, E, mask), reps=9)
    say(f"[3b] K4 flash_attention_relkey [8, 16, 1500, 64], E [73, 64], masked: "
        f"max|kernel-plain| {err:.3e}  kernel {ms:.3f} ms  plain {plain_ms:.3f} ms")
    if not err <= KERNEL_ATOL:
        raise AssertionError(f"K4 differs from its plain version by {err}")

    q, k, v = q[:2, :12].contiguous(), k[:2, :12].contiguous(), v[:2, :12].contiguous()
    out = flash_attention_relkey(q, k, v, None, None)
    err_norel = (out - flash_attention_relkey_plain(q, k, v, None, None)).abs().max().item()
    ms_norel = cuda_ms(lambda: flash_attention_relkey(q, k, v, None, None), reps=9)
    plain_norel = cuda_ms(lambda: flash_attention_relkey_plain(q, k, v, None, None), reps=9)
    say(f"[3b] K4 no rel, no mask [2, 12, 1500, 64]: max|kernel-plain| {err_norel:.3e}  "
        f"kernel {ms_norel:.3f} ms  plain {plain_norel:.3f} ms")
    if not err_norel <= KERNEL_ATOL:
        raise AssertionError(f"K4 (no rel) differs from its plain version by {err_norel}")
    # two T x T products per head, and q . E^T for the rel term; the bound
    # is f32-accurate products in 3xTF32, the FMA bound beside it
    flops = (4 * T * T + 2 * T * E.shape[0]) * 64 * B * H
    moved = 4 * B * H * T * 64 * 4 + nbytes(E, mask)
    # no single PyTorch call computes the rel-key form
    return {"flash_attention_relkey": dict(
        max_abs_err=max(err, err_norel), ms=ms, plain_ms=plain_ms, library_ms=None,
        **bound(flops, moved, "tf32x3"), bound_f32_ms=bound(flops, moved, "f32")["bound_ms"])}


def _check_ids(ids, shape):
    if ids.shape != shape or ids.dtype != np.int16:
        raise AssertionError(f"ids {ids.shape} {ids.dtype}, expected {shape} int16")
    if ids.min() < 0 or ids.max() >= 2048:
        raise AssertionError(f"ids outside [0, 2048): {ids.min()}..{ids.max()}")


def phase4b_semantic_m(dev, tmp):
    """The semantic_m entry points, then one B=8 x 30 s forward with the
    counts zeroed just before it; returns K4's launch count over the entry
    points, that forward's ``linear_3xtf32`` launches and the facade (its
    seed-0 encoder is reused by phase 5b)."""
    rng = np.random.default_rng(8)
    clip90 = (0.2 * rng.standard_normal(90 * SR_M)).astype(np.float32)
    clip7 = (0.2 * rng.standard_normal(7 * SR_M + 123)).astype(np.float32)
    pcm30 = (rng.standard_normal((32, 30 * SR_M)) * 3000).clip(-32768, 32767).astype(np.int16)
    for name, clip in (("m90.wav", clip90), ("m7.wav", clip7)):
        write_wav(os.path.join(tmp, name), clip[None], SR_M)
    t0 = time.perf_counter()
    at = AudioToken(Tokenizers.semantic_m, weights="random", device=dev)
    at.load_encoder()
    enc = at.encoder
    say(f"[4b] Wav2VecBertEncoder built (random weights, seed 0) in "
        f"{time.perf_counter() - t0:.1f} s")
    enc(pcm30[:8])  # warm up cuBLAS and the allocator
    torch.cuda.synchronize()

    reset_counts()
    forwards = 0
    ids = at.encode(os.path.join(tmp, "m7.wav"))
    forwards += 1
    _check_ids(ids, (1, 1, (1 + (7 * SR_M + 123 - 400) // 160) // 2))
    ids = at.encode(os.path.join(tmp, "m90.wav"), chunk_size=30)
    forwards += 3
    _check_ids(ids, (1, 1, 3 * 1499))
    for B in (8, 32):
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ids = enc(pcm30[:B])
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            forwards += 1
            _check_ids(ids, (B, 1, 1499))
            if B == 8:
                ids8 = ids  # phase 7a's reference
        wall = statistics.median(walls)
        say(f"[4b] Wav2VecBertEncoder B={B} x 30 s int16: median wall {wall * 1e3:.1f} ms "
            f"(runs {', '.join(f'{w * 1e3:.1f}' for w in walls)}), RTFx {B * 30.0 / wall:.1f}")
    n = flash_attention_relkey.launches
    say(f"[4b] K4 launches during the semantic_m main path: {n} over {forwards} forwards; "
        f"linear_3xtf32: {linear_3xtf32.launches}")
    if n < W2V_BLOCKS * forwards:
        raise AssertionError(f"K4 launched {n} times, expected >= {W2V_BLOCKS} x {forwards}")
    if linear_3xtf32.launches * W2V_BLOCKS != LINEAR_LAUNCHES * n:  # 191 a conformer forward
        raise AssertionError(f"linear_3xtf32 launched {linear_3xtf32.launches} times beside "
                             f"{n} of K4, expected {LINEAR_LAUNCHES} for every {W2V_BLOCKS}")
    reset_counts()
    enc(pcm30[:8])
    torch.cuda.synchronize()
    one = (flash_attention_relkey.launches, linear_3xtf32.launches)
    say(f"[4b] one B=8 x 30 s forward: K4 {one[0]}, linear_3xtf32 {one[1]} launches")
    if one != (W2V_BLOCKS, LINEAR_LAUNCHES):
        raise AssertionError(f"one forward launched K4 {one[0]} and linear_3xtf32 {one[1]} "
                             f"times, expected {W2V_BLOCKS} and {LINEAR_LAUNCHES}")
    return n, one[1], at, (pcm30[:8], ids8)


def phase5b_semantic_m_goldens(dev, tmp, at, keep):
    """The semantic_m golden gate; ``keep`` gets each seed's encoder and
    battery line (for phase 5f)."""
    g = np.load(os.path.join(parity.GOLD, "battery_semantic_m.npz"))
    audio, lengths, names = battery(SR_M)
    failures = []
    for seed in WEIGHT_SEEDS:
        enc = keep.setdefault("encs", {})[seed] = (
            at.encoder if seed == 0
            else Wav2VecBertEncoder(weights="random", seed=seed, device=dev))
        ids = enc(audio, attention_mask=lengths)
        ref = g[f"ids_s{seed}"]
        per_case = (ids.reshape(len(names), -1) == ref.reshape(len(names), -1)).mean(axis=1)
        keep.setdefault("lines", {})[seed] = per_case
        for name, agree in zip(names, per_case):
            if ("semantic_m", name) in parity.DEGENERATE_CASES:
                ok, gate = parity.degenerate_ok(float(agree)), "binary: >= 0.9 or <= 0.1"
            else:
                thresh = parity.case_thresh("semantic_m", name)
                ok, gate = agree >= thresh, f">= {thresh}"
            say(f"[5b] battery s{seed:<2d} {name:14s} agreement {agree:.6f} ({gate}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"s{seed} {name} {agree:.6f}")

    g = np.load(os.path.join(parity.GOLD, "api_semantic_m.npz"))
    for name, wav in api_clips(SR_M, at.encoder.buckets).items():
        if name == "multichunk_90s":
            path = os.path.join(tmp, "api_m90.wav")
            write_wav(path, (np.clip(wav, -1, 1) * 32767.0).astype(np.int16)[None], SR_M)
            toks = at.encode(path, chunk_size=30.0)
        else:
            toks = at.encode(wav[None].astype(np.float32))
        ref = g[f"tokens_{name}"]
        agree = float((toks == ref).mean()) if toks.shape == ref.shape else 0.0
        ok = agree >= parity.THRESH
        say(f"[5b] api {name:14s} agreement {agree:.6f} (>= {parity.THRESH}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"api {name} {agree:.6f}")
    if failures:
        raise AssertionError("semantic_m golden gate failed: " + "; ".join(failures))


def _randn(dev, shape, dtype, seed, scale=1.0):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * scale
    return torch.from_numpy(a).to(dev).to(dtype)


def _compare(name, out, ref, dt, share=BF16_SHARE):
    """max |kernel - plain|, raising past the stated bound for the dtype
    (in bf16 ``share`` of the output's scale)."""
    err = (out.float() - ref.float()).abs().max().item()
    bound = KERNEL_ATOL if dt == torch.float32 else share * ref.float().abs().max().item()
    if not err <= bound:
        raise AssertionError(f"{name} {dt} differs from its plain version by {err} > {bound}")
    return err


def phase3c_decode_kernels(dev):
    """K5, K6 and K7 against their plain versions at the decode paths'
    shapes, in bf16 (the default stage dtype) and f32 (the parity path)."""
    res = {"flash_attention_plain": {}, "decode_attention": {}, "decode_qkv": {},
           "decode_ffn": {}, "decode_ffn_tp": {}}

    def record(name, dt, B, err, ms, plain_ms, flops, moved, library_ms=None):
        r = res[name]
        if dt == torch.float32:
            r["max_abs_err"] = max(r.get("max_abs_err", 0.0), err)
        else:
            r["max_abs_err_bf16"] = max(r.get("max_abs_err_bf16", 0.0), err)
        if dt == torch.bfloat16 and B == 8:  # the semantic decode main path's shape
            r.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                     **bound(flops, moved, "bf16"))
        elif name == "flash_attention_plain":  # K5's f32 path, on K4's 3xTF32 kernel
            r["f32"] = dict(source="audiotoken_tpu_torch/csrc/flash_attention.cu", ms=ms,
                            plain_ms=plain_ms, library_ms=library_ms,
                            **bound(flops, moved, "tf32x3"),
                            bound_f32_ms=bound(flops, moved, "f32")["bound_ms"])

    for dt in (torch.bfloat16, torch.float32):
        q = _randn(dev, (8, 16, 1024, 64), dt, 1, 0.125)
        k, v = _randn(dev, (8, 16, 1024, 64), dt, 2), _randn(dev, (8, 16, 1024, 64), dt, 3)
        err = _compare("K5", flash_attention_plain(q, k, v), noncausal_attention_plain(q, k, v), dt,
                       K5_SHARE)
        ms = device_ms(lambda: flash_attention_plain(q, k, v))
        plain_ms = device_ms(lambda: noncausal_attention_plain(q, k, v))
        library_ms = device_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=1.0))
        flops = 4 * 1024 * 1024 * 64 * 8 * 16
        kind = "bf16" if dt == torch.bfloat16 else "tf32x3"  # f32: K4's 3xTF32 kernel
        b = bound(flops, 4 * nbytes(q), kind)
        fma = (f", {bound(flops, 0, 'f32')['bound_ms']:.3f} ms as f32 FMAs"
               if kind == "tf32x3" else "")
        say(f"[3c] K5 flash_attention_plain [8, 16, 1024, 64] {dt}: max|kernel-plain| "
            f"{err:.3e}  kernel {ms:.3f} ms  plain {plain_ms:.3f} ms  SDPA {library_ms:.3f} ms  "
            f"bound {b['bound_ms']:.4f} ms ({kind}, {b['bound_by']}){fma}")
        record("flash_attention_plain", dt, 8, err, ms, plain_ms, flops, 4 * nbytes(q),
               library_ms)
        del q, k, v

        for B in (8, 32):
            nh, L = 12, 1024
            kc, vc = _randn(dev, (B, nh, L, 64), dt, 5), _randn(dev, (B, nh, L, 64), dt, 6)
            qkv = _randn(dev, (B, 3 * nh * 64), dt, 7)
            # q, k_new, v_new: strided rows of the qkv projection, q unscaled
            q, kn, vn = qkv[:, :nh * 64], qkv[:, nh * 64: 2 * nh * 64], qkv[:, 2 * nh * 64:]
            for pos in (1023, 640, 256):
                start = torch.from_numpy(
                    np.random.default_rng(B).integers(0, 700 * pos // 1023, B).astype(np.int32)
                ).to(dev)
                start[0], start[1] = 0, pos  # a full row; a row with no valid slot
                out = decode_attention(q, kc, vc, start, pos, kn, vn)
                again = decode_attention(q, kc, vc, start, pos, kn, vn)
                if not torch.equal(out, again):
                    raise AssertionError(f"K6 {dt} B={B}: two calls differ")
                err = _compare("K6", out, decode_attention_plain(q, kc, vc, start, pos, kn, vn),
                               dt)
                ms = device_ms(lambda: decode_attention(q, kc, vc, start, pos, kn, vn))
                plain_ms = device_ms(
                    lambda: decode_attention_plain(q, kc, vc, start, pos, kn, vn))
                # the library yardstick: SDPA of the one-token query (scaled) over
                # the cache with the token's k and v already in slot pos (written
                # here, outside the timed call) and a boolean mask of the slots
                # [start, pos]
                kl, vl = kc.clone(), vc.clone()
                kl[:, :, pos], vl[:, :, pos] = kn.view(B, nh, 64), vn.view(B, nh, 64)
                slot = torch.arange(L, device=dev)[None, :]
                mask = ((slot >= start.long()[:, None]) & (slot <= pos))[:, None, None, :]
                qs = (q * 0.125).reshape(B, nh, 1, 64)
                lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                    qs, kl, vl, attn_mask=mask, scale=1.0)
                lib_err = (lib().reshape(B, nh * 64).float() - out.float()).abs().max().item()
                library_ms = device_ms(lib)
                del kl, vl
                # this run's data: each row reads its slots [start, pos) of k and v
                slots = int((pos - start.clamp(max=pos)).sum().item())
                es = q.element_size()
                # (q, k_new and v_new in; the output and the appended slot out)
                moved = (2 * slots * nh * 64 + 6 * B * nh * 64) * es
                b = bound(4 * (slots + B) * nh * 64, moved, "bf16")
                say(f"[3c] K6 decode_attention B={B} x 12 heads, slot {pos} of 1024 {dt}: "
                    f"max|kernel-plain| {err:.3e}, two calls equal  kernel {ms:.4f} ms  plain "
                    f"{plain_ms:.4f} ms  SDPA with the slot mask {library_ms:.4f} ms "
                    f"(max|kernel-SDPA| {lib_err:.3e})  bound {b['bound_ms']:.4f} ms "
                    f"({b['bound_by']}, {slots} slots read)")
                if pos == 1023:
                    record("decode_attention", dt, B, err, ms, plain_ms,
                           4 * (slots + B) * nh * 64, moved, library_ms)
                    if dt == torch.bfloat16 and B == 32:
                        res["decode_attention"].update(ms_b32=ms, plain_ms_b32=plain_ms,
                                                       library_ms_b32=library_ms,
                                                       bound_ms_b32=b["bound_ms"])
                elif dt == torch.bfloat16:
                    res["decode_attention"][f"ms_b{B}_pos{pos}"] = ms
                    res["decode_attention"][f"bound_ms_b{B}_pos{pos}"] = b["bound_ms"]

            C = 768
            x, a = _randn(dev, (B, C), dt, 10), _randn(dev, (B, C), dt, 11)
            ln1, ln2 = 1 + _randn(dev, (C,), dt, 12, 0.1), 1 + _randn(dev, (C,), dt, 13, 0.1)
            wqkv, wo = _randn(dev, (3 * C, C), dt, 14, 0.02), _randn(dev, (C, C), dt, 15, 0.02)
            wi, w2 = _randn(dev, (4 * C, C), dt, 16, 0.02), _randn(dev, (C, 4 * C), dt, 17, 0.02)
            qkv_args = (x, ln1, None, wqkv, None)
            ffn_args = (x, a, wo, ln2, None, wi, w2)
            # a tp=2 rank's shard: half of a's columns and of the MLP's
            tp_w = (wo[:, :C // 2].contiguous(), wi[:2 * C].contiguous(),
                    w2[:, :2 * C].contiguous())
            tp_args = (x, a[:, :C // 2].contiguous(), tp_w[0], ln2, None, tp_w[1], tp_w[2],
                       _one_rank)
            for name, fn, plain, args in (("decode_qkv", decode_qkv, decode_qkv_plain, qkv_args),
                                          ("decode_ffn", decode_ffn, decode_ffn_plain, ffn_args),
                                          ("decode_ffn_tp", decode_ffn_tp, decode_ffn_tp_plain,
                                           tp_args)):
                err = _compare(f"K7 {name}", fn(*args), plain(*args), dt)
                if dt == torch.float32:
                    res[name]["max_abs_err"] = max(res[name].get("max_abs_err", 0.0), err)
                    say(f"[3c] K7 {name} B={B}, 768 wide {dt}: max|kernel-plain| {err:.3e}  "
                        f"kernel {device_ms(lambda: fn(*args)):.4f} ms (weights warm)")
                else:
                    res[name]["max_abs_err_bf16"] = max(res[name].get("max_abs_err_bf16", 0.0), err)
            if B == 8:  # K6 as the decode step launches it: chained after decode_qkv
                qkv = decode_qkv(*qkv_args)
                q, kn, vn = qkv[:, :C], qkv[:, C:2 * C], qkv[:, 2 * C:]
                start = torch.zeros(B, dtype=torch.int32, device=dev)
                start[1] = 1023  # a row with no valid slot
                out = decode_attention(q, kc, vc, start, 1023, kn, vn, chained=True)
                err = _compare("K6 chained", out,
                               decode_attention_plain(q, kc, vc, start, 1023, kn, vn), dt)
                key = "max_abs_err" if dt == torch.float32 else "max_abs_err_bf16"
                r = res["decode_attention"]
                r[key] = max(r.get(key, 0.0), err)
                say(f"[3c] K6 decode_attention B=8, slot 1023 {dt}, chained after decode_qkv: "
                    f"max|kernel-plain| {err:.3e}")
            if dt == torch.bfloat16:
                _k7_cold(dev, res, x, a, ln1, ln2, (wqkv,), (wo, wi, w2), tp_args[1], tp_w)
    return res


def _one_rank(s):
    """decode_ffn_tp's all-reduce on a world of one: the identity."""
    return s


def _weight_sets(dev, first, seed):
    """``first`` (a tuple of weights) and more sets of the same shapes, drawn
    on the device, until they hold at least 6 sets and more than the L2."""
    per = nbytes(*first)
    n = max(6, -(-(L2_BYTES + 16 * 2**20) // per))
    g = torch.Generator(device=dev).manual_seed(seed)
    return [first] + [tuple((torch.randn(w.shape, generator=g, device=dev) * 0.02).to(w.dtype)
                            for w in first) for _ in range(n - 1)]


def _k7_cold(dev, res, x, a, ln1, ln2, qkv_w, ffn_w, a_tp, tp_w):
    """K7 in bf16 timed cold (each call reads weights no other call of the
    queue read since they left the L2), beside its plain version and the
    unfused chain of PyTorch calls for the same function (which the port
    never calls), all under the same condition; and warm, one weight set.
    ``a_tp`` and ``tp_w``: a tp=2 rank's shard, for decode_ffn_tp."""
    B, C = x.shape
    chain_qkv = lambda w: F.linear(F.layer_norm(x, (C,), ln1, None, 1e-5), w)  # noqa: E731

    def chain(a):
        def run(wo, wi, w2):
            x1 = F.linear(a, wo) + x
            return F.linear(F.gelu(F.linear(F.layer_norm(x1, (C,), ln2, None, 1e-5), wi)),
                            w2) + x1
        return run

    qkv = lambda fn: lambda w: fn(x, ln1, None, w)  # noqa: E731
    ffn = lambda fn: lambda wo, wi, w2: fn(x, a, wo, ln2, None, wi, w2)  # noqa: E731
    tp = lambda fn: lambda wo, wi, w2: fn(x, a_tp, wo, ln2, None, wi, w2, _one_rank)  # noqa: E731
    for name, first, kern, plain, chain_fn in (
            ("decode_qkv", qkv_w, qkv(decode_qkv), qkv(decode_qkv_plain), chain_qkv),
            ("decode_ffn", ffn_w, ffn(decode_ffn), ffn(decode_ffn_plain), chain(a)),
            ("decode_ffn_tp", tp_w, tp(decode_ffn_tp), tp(decode_ffn_tp_plain), chain(a_tp))):
        sets = _weight_sets(dev, first, len(first) * 1000 + B)
        cold = {k: cold_ms([lambda f=f, ws=ws: f(*ws) for ws in sets])
                for k, f in (("kernel", kern), ("plain", plain), ("chain", chain_fn))}
        warm = device_ms(lambda: kern(*first))
        # the weights read once, the rows in and out; 2 B x (weights) operations
        flops = 2 * B * sum(w.numel() for w in first)
        moved = (nbytes(x, ln1, *first) + 3 * nbytes(x) if name == "decode_qkv"
                 else nbytes(x, a if name == "decode_ffn" else a_tp, ln2, *first) + nbytes(x))
        b = bound(flops, moved, "bf16")
        shard = ", a tp=2 rank's shard" if name == "decode_ffn_tp" else ""
        say(f"[3c] K7 {name} B={B}, 768 wide{shard} bf16, weights cold ({len(sets)} sets, "
            f"{len(sets) * nbytes(*first) / 2**20:.0f} MiB): kernel {cold['kernel']:.4f} ms  plain "
            f"{cold['plain']:.4f} ms  chain of PyTorch calls {cold['chain']:.4f} ms  bound "
            f"{b['bound_ms']:.4f} ms ({b['bound_by']}); weights warm: kernel {warm:.4f} ms")
        r = res[name]
        if B == 8:  # the semantic decode main path's shape
            r.update(ms=cold["kernel"], warm_ms=warm, plain_ms=cold["plain"],
                     chain_ms=cold["chain"], library_ms=None, **b)
        else:
            r.update(ms_b32=cold["kernel"], warm_ms_b32=warm, plain_ms_b32=cold["plain"],
                     chain_ms_b32=cold["chain"], bound_ms_b32=b["bound_ms"])
        del sets
    return res


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase4c_decode(dev):
    """The decode entry points; returns K2's and the decode kernels'
    launch counts from this phase."""
    rng = np.random.default_rng(9)
    codes30 = rng.integers(0, 1024, (32, 8, 2250)).astype(np.int32)
    at = AudioToken(Tokenizers.acoustic, num_codebooks=8, weights="random", device=dev)
    at.load_decoder()
    dec = at.decoder
    dec.forward_codes(codes30[:8])  # warm up cuDNN's algorithm choice and the allocator
    torch.cuda.synchronize()

    reset_counts()
    wav = at.decode(codes30[:1])
    if wav.shape != (1, 2250 * 320) or not np.isfinite(wav).all():
        raise AssertionError(f"acoustic decode: {wav.shape}, finite {np.isfinite(wav).all()}")
    for B in (8, 32):
        torch.cuda.reset_peak_memory_stats(dev)
        walls = []
        for _ in range(3):
            out, wall = _timed(lambda: dec.forward_codes(codes30[:B]))
            walls.append(wall)
            if tuple(out.shape) != (B, 2250 * 320) or not torch.isfinite(out).all():
                raise AssertionError(f"AcousticDecoder B={B}: {tuple(out.shape)}")
            del out
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        wall = statistics.median(walls)
        say(f"[4c] AcousticDecoder B={B} x 30 s: median wall {wall * 1e3:.1f} ms (runs "
            f"{', '.join(f'{w * 1e3:.1f}' for w in walls)}), RTFx {B * 30.0 / wall:.1f}, "
            f"peak device memory {peak:.2f} GiB")
    say(f"[4c] AcousticDecoder B=8 profiled: "
        f"{device_split(lambda: dec.forward_codes(codes30[:8]))}")
    if lstm_layer.launches < 2 * 7:
        raise AssertionError(f"K2 launched {lstm_layer.launches} times in the acoustic decoder")
    k2 = lstm_layer.launches
    elu_pad_n = elu_pad.launches
    _check_elu_pad_launches("[4c]", "decoder", lambda B: dec.forward_codes(codes30[:B]))
    del at, dec
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    at = AudioToken(Tokenizers.semantic_m, weights="random", device=dev)
    at.load_decoder()
    sem = at.decoder
    say(f"[4c] Wav2VecBertDecoder built (random weights, seed 0, bf16 AR and fine stages) in "
        f"{time.perf_counter() - t0:.1f} s")
    sources = [np.random.default_rng(100 + i).integers(0, 2048, 250) for i in range(8)]
    sem.max_new_tokens = 64
    sem.decode_batch(sources, seed=1)  # warm up cuBLAS and the allocator
    sem.max_new_tokens = 1024
    torch.cuda.synchronize()

    reset_counts()
    steps0, passes0 = sem.gpt.decode_steps, sem.bark.passes
    torch.cuda.reset_peak_memory_stats(dev)
    wavs, wall = _timed(lambda: at.decode_batch(sources))
    steps, passes = sem.gpt.decode_steps - steps0, sem.bark.passes - passes0
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    counts = {k.__name__: k.launches for k in DECODE_KERNELS}
    # two more decodes of the same sources: the host's share varies
    walls = [wall] + [_timed(lambda: at.decode_batch(sources))[1] for _ in range(2)]
    wall = statistics.median(walls)
    steps0 = sem.gpt.decode_steps
    for w in wavs:
        if (w.dtype != np.float32 or w.ndim != 2 or w.shape[0] != 1 or w.shape[1] % 320
                or not np.isfinite(w).all()):
            raise AssertionError(f"semantic decode output {w.shape} {w.dtype}")
    audio_s = sum(w.shape[1] for w in wavs) / 24_000
    say(f"[4c] AudioToken(semantic_m).decode_batch 8 x 250 ids: median wall {wall:.3f} s "
        f"(runs {', '.join(f'{w:.3f}' for w in walls)}), audio {audio_s:.2f} s, real-time "
        f"factor {audio_s / wall:.2f}, {steps} decode steps, {passes} fine passes, "
        f"peak device memory {peak:.2f} GiB")

    # the stages alone, and int16 output equal to the float path's bytes
    rows, ar_wall = _timed(lambda: sem._ar_stage(sources, 7))
    n_tok = sum(2 * r.shape[1] for r in rows)
    steps_ar = sem.gpt.decode_steps - steps0
    say(f"[4c] AR stage: {ar_wall:.3f} s, {n_tok} acoustic tokens kept: "
        f"{n_tok / ar_wall:.0f} tokens/s ({steps_ar} decode steps of 8 rows, "
        f"{steps_ar / ar_wall:.0f} steps/s)")
    wav_f, fin_wall = _timed(lambda: sem._finish_stage(rows, 7))
    sem.acoustic_decoder.output_dtype = "int16"
    wav_i = sem._finish_stage(rows, 7)
    sem.acoustic_decoder.output_dtype = "float32"
    for f, i in zip(wav_f, wav_i):
        ref = np.clip(np.round(np.clip(f, -0.99, 0.99) * 32768.0), -32768, 32767).astype(np.int16)
        if i.dtype != np.int16 or not np.array_equal(i, ref):
            raise AssertionError("int16 output differs from the float path's WAV samples")
    say(f"[4c] fine + EnCodec stages: {fin_wall:.3f} s; int16 output equals the float "
        f"path's WAV samples")

    say(f"[4c] decode kernel launches during semantic decode: {counts}")
    if counts["decode_attention"] < GPT_LAYERS * steps or steps < 1:
        raise AssertionError(f"K6 launched {counts['decode_attention']} times in {steps} steps")
    for name in ("decode_qkv", "decode_ffn"):
        if counts[name] < GPT_LAYERS * steps:
            raise AssertionError(f"K7 {name} launched {counts[name]} times in {steps} steps")
    if counts["flash_attention_plain"] < FINE_LAYERS * passes or passes < 1:
        raise AssertionError(f"K5 launched {counts['flash_attention_plain']} times "
                             f"in {passes} passes")
    counts["lstm_layer"], counts["elu_pad"] = k2, elu_pad_n
    phase4f_pipeline(dev, sem)
    del at, sem
    torch.cuda.empty_cache()
    return counts


def phase4f_pipeline(dev, sem):
    """``decode_batch(..., pipeline_batch=8)`` of 16 x 250 ids against two
    serial ``decode_batch`` calls of 8 with the chunk seeds, in turns
    (serial, pipelined, serial, pipelined), with ``PIPE_NEW_TOKENS`` new
    tokens (the go/no-go at 1024 is ``scripts/profile_decode_torch.py
    --pipeline 8``): the AR tokens and the fine codes of every chunk equal
    in all four runs, the fine stage on a stream of its own in the
    pipelined runs only, and each pipelined run's launches of K5, K6 and
    K7 counted from 0; both walls and the waveforms' largest difference
    printed."""
    sources = [np.random.default_rng(200 + i).integers(0, 2048, 250) for i in range(16)]
    sem.max_new_tokens = PIPE_NEW_TOKENS
    stride = sem._CHUNK_SEED_STRIDE
    seen = {}  # (stage, seed) -> each run's output
    side = {"serial": [], "pipelined": []}  # per fine stage: on a stream of its own?
    ar, fine = sem._ar_stage, sem._fine_stage
    label = None

    def ar_seen(srcs, seed):
        rows = ar(srcs, seed)
        seen.setdefault(("ar", seed), []).append(rows)
        return rows

    def fine_seen(rows, seed):
        out = fine(rows, seed)
        seen.setdefault(("fine", seed), []).append(out[0])
        side[label].append(torch.cuda.current_stream(dev) != torch.cuda.default_stream(dev))
        return out

    sem._ar_stage, sem._fine_stage = ar_seen, fine_seen
    runs, launches = [], []  # launches: each pipelined run's counts, decode steps, fine passes
    try:
        for label in ("serial", "pipelined", "serial", "pipelined"):
            torch.cuda.synchronize()
            steps0, passes0 = sem.gpt.decode_steps, sem.bark.passes
            reset_counts()
            t0 = time.perf_counter()
            if label == "serial":
                wavs = (sem.decode_batch(sources[:8], seed=11)
                        + sem.decode_batch(sources[8:], seed=11 + stride))
            else:
                wavs = sem.decode_batch(sources, seed=11, pipeline_batch=8)
            torch.cuda.synchronize()
            runs.append((label, time.perf_counter() - t0, wavs))
            if label == "pipelined":
                launches.append(({k.__name__: k.launches for k in DECODE_KERNELS},
                                 sem.gpt.decode_steps - steps0, sem.bark.passes - passes0))
    finally:
        del sem._ar_stage, sem._fine_stage
        sem.max_new_tokens = 1024
    audio_s = sum(w.shape[1] for w in runs[0][2]) / 24_000
    ref = runs[0][2]
    diff = max(float(np.abs(a - b).max()) if a.shape == b.shape else float("inf")
               for _, _, wavs in runs[1:] for a, b in zip(wavs, ref))
    say(f"[4f] 16 x 250 ids, {PIPE_NEW_TOKENS} new tokens, chunk 8, in turns: " + ", ".join(
        f"{lab} {wall:.3f} s (real-time factor {audio_s / wall:.2f})" for lab, wall, _ in runs)
        + f"; waveforms' largest |pipelined - serial| {diff:.3e}")
    failures = [f"{stage} seed {seed}: {len(outs)} runs" for (stage, seed), outs in seen.items()
                if len(outs) != 4]
    for (stage, seed), outs in sorted(seen.items()):
        for o in outs[1:]:
            same = (all(np.array_equal(a, b) for a, b in zip(o, outs[0])) if stage == "ar"
                    else np.array_equal(o, outs[0]))
            if not same:
                failures.append(f"{stage} seed {seed} differs between runs")
    if any(side["serial"]) or not side["pipelined"] or not all(side["pipelined"]):
        failures.append(f"fine stage streams {side}")
    for counts, steps, passes in launches:
        say(f"[4f] pipelined run: {steps} decode steps, {passes} fine passes, kernel launches "
            f"{counts}")
        if (steps < 1 or passes < 1 or counts["flash_attention_plain"] < FINE_LAYERS * passes
                or min(counts[n] for n in ("decode_attention", "decode_qkv", "decode_ffn"))
                < GPT_LAYERS * steps):
            failures.append(f"pipelined launches {counts} in {steps} steps, {passes} passes")
    say(f"[4f] AR tokens and fine codes of both chunks equal in all four runs: "
        f"{'yes' if not failures else 'NO'}; the fine stage on a stream of its own in the "
        f"pipelined runs ({sum(side['pipelined'])} of {len(side['pipelined'])}) and not in "
        f"the serial ones")
    if failures:
        raise AssertionError("pipeline_batch: " + "; ".join(failures))


def _si_snr(est, ref):
    est, ref = est - est.mean(), ref - ref.mean()
    target = (est @ ref) / (ref @ ref) * ref
    return 10 * np.log10((target @ target) / max(((est - target) ** 2).sum(), 1e-30))


def phase5c_decode_goldens(dev):
    g = np.load(os.path.join(HERE, "tests", "torch_goldens", "decode_semantic_m_s0.npz"))
    dec = Wav2VecBertDecoder(weights="random", seed=0, device=dev, top_k=1, max_new_tokens=96,
                             precision="highest", ar_dtype="float32", ar_precision="highest",
                             fine_dtype="float32", fine_precision="highest")
    vocab = dec.config.vocab
    stop = vocab.stop_token[COMMONS.ACOUSTIC]
    prompts = [p[p >= 0] for p in g["prompts"]]
    with dec.ar_policy.numerics():
        tokens = dec.gpt.generate_batch(prompts, max_new_tokens=96, temperature=0.8, top_k=1,
                                        stop_token=stop, seed=0)
    failures = _ar_rows_gate("5c", tokens, g)

    with dec.fine_policy.numerics():
        fine = dec.bark.generate_fine_batch(g["coarse"], temperature=None, seed=0)
    agree = float((fine == g["fine"]).mean())
    say(f"[5c] fine codes from the golden coarse input: agreement {agree:.6f} (>= 0.999) "
        f"{'ok' if agree >= 0.999 else 'FAIL'}")
    if agree < 0.999:
        failures.append(f"fine {agree:.6f}")

    # the same fine stage at the decoder's default fine_precision in f32
    # (fine_dtype="float32", fine_precision="default"): K5's one-pass form
    fine_policy = get_policy("default")
    gen = BarkFineGenerator(dec.bark.model, precision=fine_policy.matmul_precision)
    reset_counts()
    with fine_policy.numerics():
        fine1 = gen.generate_fine_batch(g["coarse"], temperature=None, seed=0)
    torch.cuda.synchronize()
    onepass = flash_attention_plain.launches_1pass
    agree1 = float((fine1 == g["fine"]).mean())
    ok = onepass == FINE_LAYERS * gen.passes and flash_attention_plain.launches == 0
    say(f"[5c] fine codes at fine_precision='default' (K5 in one TF32 pass): agreement with "
        f"the golden {agree1:.6f} (not gated); K5 launches one pass {onepass}, 3xTF32 "
        f"{flash_attention_plain.launches} ({FINE_LAYERS} x {gen.passes} passes expected in "
        f"one pass) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"fine at default launched K5 {onepass} one-pass, "
                        f"{flash_attention_plain.launches} 3-pass")

    acoustic = dec.acoustic_decoder
    wav = acoustic.forward_codes(g["fine"]).cpu().numpy()
    acoustic.output_dtype = "int16"
    wav_i = acoustic.forward_codes(g["fine"]).cpu().numpy()
    for i in range(wav.shape[0]):
        snr = _si_snr(wav[i].astype(np.float64), g["wav_f32"][i].astype(np.float64))
        lsb = float((np.abs(wav_i[i].astype(np.int32) - g["wav_i16"][i]) <= 1).mean())
        ok = snr >= 60.0 and lsb >= 0.9999
        say(f"[5c] waveform row {i}: SI-SNR {snr:.1f} dB (>= 60), int16 within 1 LSB on "
            f"{lsb:.6f} (>= 0.9999) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"waveform row {i} {snr:.1f} dB {lsb:.6f}")
    del dec
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError("decode golden gate failed: " + "; ".join(failures))
    return onepass


def _ar_rows_gate(tag, tokens, g):
    """The greedy AR rows against the decode golden ``g``: equal, or first
    different at a step whose golden top-1/top-2 margin is below
    ``GOLDEN_MARGIN`` -> the failures."""
    failures = []
    for i, (row, ref, margin) in enumerate(zip(tokens, g["tokens"], g["margins"])):
        diff = np.flatnonzero(row != ref)
        if not diff.size:
            say(f"[{tag}] AR row {i}: {int((ref >= 0).sum())} greedy tokens equal to the golden")
            continue
        j = int(diff[0])
        if margin[j] < GOLDEN_MARGIN:
            say(f"[{tag}] AR row {i}: first difference at step {j}, golden top-1/top-2 margin "
                f"{margin[j]:.3e} < {GOLDEN_MARGIN}: a near-tie; row stopped there")
        else:
            failures.append(f"AR row {i} step {j} (margin {margin[j]:.3e})")
            say(f"[{tag}] AR row {i}: differs at step {j}, margin {margin[j]:.3e} FAIL")
    return failures


#: the instantiations of csrc/flash_attention_bf16.cu's kernels, by their
#: template arguments in the build log: (TERMS, MODE, KT) of
#: attention_bf16_kernel, R of attn_onepass_bf16_kernel
K8_FORMS = {("0", "3", "64"): "K5 / full64", ("1", "3", "64"): "K4 bf16",
            ("0", "0", "64"): "noexp64", ("0", "0", "128"): "noexp128",
            ("0", "1", "64"): "dotsonly64", ("0", "1", "128"): "dotsonly128",
            ("16",): "onepass16", ("32",): "onepass32"}


def build_lines(patterns, forms):
    """``ptxas -v``'s registers, barriers, stack and spill for each kernel
    instantiation whose name matches one of the regular expressions
    ``patterns``, named by ``forms`` from the match's groups (its template
    arguments)."""
    log, out = _build.build_log().splitlines(), []
    for i, line in enumerate(log):
        if "Compiling entry" not in line:
            continue
        m = next(filter(None, (re.search(p, line) for p in patterns)), None)
        if m:
            props = [x.strip().replace("ptxas info    : ", "") for x in log[i + 1:i + 4]
                     if "registers" in x or "spill" in x]
            out.append(f"{forms.get(m.groups(), m.group(0))}: " + "; ".join(props))
    return out


def phase3d_attn_ablation(dev):
    """K8 against its twins at the micro-profile's shape, ``full64`` bit for
    bit against K5, then the K8 path: the attention micro-profile, driven
    with K8's counts at 0. Returns the entries of the K8 kernels and their
    launch counts from that run."""
    for line in build_lines([r"attention_bf16_kernelILb(\d)ELi(\d+)ELi(\d+)EE",
                             r"attn_onepass_bf16_kernelILi(\d+)EE"], K8_FORMS):
        say(f"[3d] K5's bf16 kernel and K8, {line}")
    B, H, T, dh = 16, 16, 1024, 64
    q, k, v = micro.inputs(B, H, T, dh, dev, seed=0)
    res = {}
    for case in CASES:
        mode = case.rstrip("0123456789")
        tile = int(case[len(mode):])
        out = attn_ablation(q, k, v, mode, tile)
        ref = attn_ablation_plain(q, k, v, mode, tile)
        err = (out.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        if case == "full64" and not torch.equal(out, flash_attention_plain(q, k, v)):
            raise AssertionError("K8 full64 is not K5's kernel: their outputs differ")
        del out, ref
        plain_ms = cuda_ms(lambda: attn_ablation_plain(q, k, v, mode, tile), warmup=1, reps=3)
        say(f"[3d] K8 {case:11s} [16, 16, 1024, 64] bf16: max|kernel-twin| {err:.3e} of an "
            f"output scale {scale:.3e} (bound 2^-6 of it)  twin {plain_ms:.3f} ms"
            + ("; bit for bit K5's output" if case == "full64" else ""))
        if not err <= BF16_SHARE * scale:
            raise AssertionError(f"K8 {case} differs from its twin by {err} (scale {scale})")
        # the two products, 4 T^2 dh per (batch, head), on bf16 inputs
        res[f"attn_ablation_{case}"] = dict(max_abs_err=err, out_scale=scale, plain_ms=plain_ms,
                                            **bound(4 * T * T * dh * B * H, 4 * nbytes(q), "bf16"))
    del q, k, v

    reset_counts()
    times = micro.micro_profile(B, H, T, dh, layers=24, device=dev)
    counts = {case: attn_ablation.launches[case] for case in CASES}
    for name, ms in times.items():
        say(f"[3d] micro-profile {name:12s} {ms:8.4f} ms/layer")
    for line in micro.split_lines(times):
        say(f"[3d] {line}")
    for case in CASES:
        # onepass and full are softmax attention (p rounded to bf16): SDPA
        # computes that function; the ablations are no function a library computes
        valid = case.startswith(("onepass", "full"))
        res[f"attn_ablation_{case}"].update(
            ms=times[case], library_ms=times["sdpa"] if valid else None)
    say(f"[3d] K8 launches during the micro-profile: {counts}")
    for case, n in counts.items():
        if n < 1:
            raise AssertionError(f"K8 {case} was not launched by the micro-profile")
    return res, counts


def phase3e_flash_norel(dev):
    """K4 in its no-rel masked form at the HuBERT shape, against its plain
    version and against SDPA given the padding bias as ``attn_mask``."""
    rng = np.random.default_rng(4)
    B, H, T = 8, 12, 1499

    def t(scale):
        return torch.from_numpy(
            (rng.standard_normal((B, H, T, 64)) * scale).astype(np.float32)).to(dev)

    q, k, v = t(0.3), t(0.3), t(1.0)
    mask = torch.ones((B, T), device=dev)
    mask[1, T - 377:] = 0.0
    mask[5, T // 2:] = 0.0
    bias = padding_bias(mask)
    out = flash_attention_relkey(q, k, v, None, mask)
    err = (out - flash_attention_relkey_plain(q, k, v, None, mask)).abs().max().item()
    lib_err = (out - F.scaled_dot_product_attention(q, k, v, attn_mask=bias)).abs().max().item()
    del out
    ms = cuda_ms(lambda: flash_attention_relkey(q, k, v, None, mask), reps=9)
    plain_ms = cuda_ms(lambda: flash_attention_relkey_plain(q, k, v, None, mask), reps=9)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias), reps=9)
    say(f"[3e] K4 no rel, masked [8, 12, 1499, 64]: max|kernel-plain| {err:.3e}  "
        f"max|kernel-SDPA| {lib_err:.3e}  kernel {ms:.3f} ms  plain {plain_ms:.3f} ms  "
        f"SDPA {library_ms:.3f} ms")
    if not err <= KERNEL_ATOL:
        raise AssertionError(f"K4 (no rel, masked) differs from its plain version by {err}")
    flops, moved = 4 * T * T * 64 * B * H, 4 * nbytes(q) + nbytes(mask)
    return {"flash_attention_norel": dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        **bound(flops, moved, "tf32x3"), bound_f32_ms=bound(flops, moved, "f32")["bound_ms"])}


def phase3f_flash_bf16(dev):
    """K4's bf16 form (csrc/flash_attention_bf16.cu): the public op on bf16
    q, k, v with the rel term and a mask at the semantic_m shape and with
    the mask alone at the HuBERT shape, its launches counted over those two
    calls; then each against its plain version, timed, beside SDPA with the
    mask as ``attn_mask`` for the mask-only form; and the form with neither
    term at T = 1024 launching K5. Returns (launches, the kernels line's
    entries)."""
    rng = np.random.default_rng(6)

    def t(shape, scale, dtype=torch.bfloat16):
        a = (rng.standard_normal(shape) * scale).astype(np.float32)
        return torch.from_numpy(a).to(dev).to(dtype)

    def masked(B, T):
        mask = torch.ones((B, T), device=dev)
        mask[1, T - 377:] = 0.0
        mask[5, T // 2:] = 0.0
        return mask

    B, H, T = 8, 16, 1500
    q, k, v = t((B, H, T, 64), 0.3), t((B, H, T, 64), 0.3), t((B, H, T, 64), 1.0)
    E, mask = t((73, 64), 0.5, torch.float32), masked(B, T)  # E rounded to bf16 by the op
    B2, H2, T2 = 8, 12, 1499
    q2, k2, v2 = t((B2, H2, T2, 64), 0.3), t((B2, H2, T2, 64), 0.3), t((B2, H2, T2, 64), 1.0)
    mask2 = masked(B2, T2)

    reset_counts()
    out = flash_attention_relkey(q, k, v, E, mask)
    launches = {"flash_attention_relkey_bf16": flash_attention_relkey_bf16.launches}
    out2 = flash_attention_relkey(q2, k2, v2, None, mask2)
    launches["flash_attention_relkey_bf16_norel"] = (flash_attention_relkey_bf16.launches
                                                     - launches["flash_attention_relkey_bf16"])
    torch.cuda.synchronize()
    say(f"[3f] K4 bf16 launches over the public op's two calls: {launches}; K4 f32 "
        f"{flash_attention_relkey.launches}")
    if list(launches.values()) != [1, 1] or flash_attention_relkey.launches:
        raise AssertionError(f"K4 bf16 launches {launches}, K4 f32 "
                             f"{flash_attention_relkey.launches}: expected 1, 1 and 0")
    n5 = flash_attention_plain.launches
    q3, k3, v3 = (x[:, :, :1024].contiguous() for x in (q, k, v))
    out3 = flash_attention_relkey(q3, k3, v3, None, None)
    err3 = _compare("K4 bf16, neither term (the K5 route)", out3,
                    noncausal_attention_plain(q3 * 0.125, k3, v3), torch.bfloat16, K5_SHARE)
    if flash_attention_plain.launches != n5 + 1 or flash_attention_relkey_bf16.launches != 2:
        raise AssertionError("bf16 with neither term at T = 1024 did not launch K5 alone")
    del out3, q3, k3, v3

    res = {}
    bias2 = mask2.bool()[:, None, None, :]
    for name, args, lib in (
        ("flash_attention_relkey_bf16", (q, k, v, E, mask), None),
        ("flash_attention_relkey_bf16_norel", (q2, k2, v2, None, mask2),
         lambda: F.scaled_dot_product_attention(q2, k2, v2, attn_mask=bias2)),
    ):
        got = out if name == "flash_attention_relkey_bf16" else out2
        err = _compare(f"K4 bf16 {name}", got, flash_attention_relkey_plain(*args),
                       torch.bfloat16, K5_SHARE)
        lib_err = None if lib is None else (got.float() - lib().float()).abs().max().item()
        ms = cuda_ms(lambda: flash_attention_relkey(*args), reps=9)
        plain_ms = cuda_ms(lambda: flash_attention_relkey_plain(*args), reps=9)
        library_ms = None if lib is None else cuda_ms(lib, reps=9)
        Bx, Hx, Tx, _ = args[0].shape
        P = 0 if args[3] is None else args[3].shape[0]
        flops = (4 * Tx * Tx + 2 * Tx * P) * 64 * Bx * Hx
        moved = 4 * nbytes(args[0]) + 2 * P * 64 + nbytes(args[4])
        res[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                         **bound(flops, moved, "bf16"))
        say(f"[3f] {name} [{Bx}, {Hx}, {Tx}, 64] bf16{', E [73, 64]' if P else ''}, masked: "
            f"max|kernel-plain| {err:.3e}"
            + ("" if lib_err is None else f"  max|kernel-SDPA| {lib_err:.3e}")
            + f"  kernel {ms:.4f} ms  plain {plain_ms:.3f} ms"
            + ("" if library_ms is None else f"  SDPA {library_ms:.4f} ms")
            + f"  bound {res[name]['bound_ms']:.4f} ms ({res[name]['bound_by']}, "
              f"{100 * res[name]['bound_ms'] / ms:.1f} % of it)")
    say(f"[3f] bf16 with neither term at T = 1024 launched K5, max|out-plain| {err3:.3e}")

    # the gate above holds the rel term only if getting it wrong moves the
    # output far past the gate
    gate = K5_SHARE * flash_attention_relkey_plain(q, k, v, E, mask).float().abs().max().item()
    misses = rel_term_misses(q, k, v, E, mask)
    say("[3f] the plain version with the rel term wrong, max|wrong-right| in units of the "
        "gate: " + ", ".join(f"{name} {d / gate:.1f}" for name, d in misses.items()))
    if min(misses.values()) < REL_SENSITIVITY * gate:
        raise AssertionError(f"3f's inputs do not hold the rel term: {misses}, gate {gate}")
    return launches, res


def rel_term_misses(q, k, v, E, mask, left=64, right=8):
    """max |plain - plain with the rel term wrong| for each way a kernel
    could get it wrong: dropped, the band shifted by one, clamped one step
    inside its left or its right edge (none inside an edge of width 0)."""
    ref = flash_attention_relkey_plain(q, k, v, E, mask, left, right).float()
    wrong = {"dropped": (None, left, right), "shifted by one": (torch.roll(E, 1, 0), left, right)}
    if left:
        wrong["left clamp one inside"] = (E[1:], left - 1, right)
    if right:
        wrong["right clamp one inside"] = (E[:-1], left, right - 1)
    return {name: (flash_attention_relkey_plain(q, k, v, e, mask, lo, hi).float() - ref)
            .abs().max().item() for name, (e, lo, hi) in wrong.items()}


#: the one-pass kernel's instantiations (csrc/flash_attention_tf32.cu) by
#: their template arguments (PRESCALED, REL)
ONEPASS_FORMS = {("1", "0"): "K5 f32", ("0", "0"): "mask only",
                 ("0", "1"): "rel, pos by wgmma (P <= 80)", ("0", "2"): "rel, P > 80"}


def onepass_smem_bytes(P):
    """Dynamic shared memory of a block of the one-pass kernel, as its
    launcher sizes it (csrc/flash_attention_tf32.cu: Q 32 KB, rounded K and
    V^T 2 x 32 KB, raw tiles 2 x 32 KB, the key bias 4 x 256 B, 13
    mbarriers; with 0 < P <= 80, E 20 KB from the next KB and the pos tile
    [128, P | 1] f32; 1 KB for the base's alignment)."""
    bars = 5 * 32768 + 4 * 256 + 13 * 8
    if not 0 < P <= 80:
        return 1024 + bars
    return 1024 + -(-bars // 1024) * 1024 + 80 * 256 + 128 * (P | 1) * 4


def phase3g_flash_onepass(dev):
    """The one-pass form of K4 and K5's f32 path (``csrc/flash_attention_tf32.cu``,
    what ``precision="default"`` and ``"high"`` launch): K4
    with the rel term and a mask at [8, 16, 1500, 64], K4 with the mask
    alone at [8, 12, 1499, 64], K5 f32 at [8, 16, 1024, 64]. Each is
    launched once through its public op at "default" (the one-pass count
    rises by one, the 3-pass count not at all), held against its TF32 twin
    within ONEPASS_SHARE of the output's scale, its distance from the f32
    twin printed; then timed beside the 3-pass kernel, the twin, and SDPA in
    f32 with the TF32 switches on (the mask as a boolean ``attn_mask``),
    with the backend SDPA took; its bound in one TF32 pass. Returns the
    kernels line's entries."""
    for line in build_lines([r"attention_tf32_kernelILb(\d)ELi(\d)E"], ONEPASS_FORMS):
        say(f"[3g] one-pass kernel, {line}")
    say(f"[3g] one-pass kernel, dynamic shared memory a block: {onepass_smem_bytes(73)} bytes "
        f"with the rel term (P = 73), {onepass_smem_bytes(0)} without; one block an SM, "
        f"setmaxnreg 200 registers a consumer thread and 56 a producer thread")
    rng = np.random.default_rng(7)

    def t(shape, scale):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)

    def masked(B, T):
        mask = torch.ones((B, T), device=dev)
        mask[1, T - 377:] = 0.0
        mask[5, T // 2:] = 0.0
        return mask

    B, H, T = 8, 16, 1500
    q, k, v, E, mask = (t((B, H, T, 64), 0.3), t((B, H, T, 64), 0.3), t((B, H, T, 64), 1.0),
                        t((73, 64), 0.02), masked(B, T))
    B2, H2, T2 = 8, 12, 1499
    q2, k2, v2, mask2 = (t((B2, H2, T2, 64), 0.3), t((B2, H2, T2, 64), 0.3),
                         t((B2, H2, T2, 64), 1.0), masked(B2, T2))
    keep2 = mask2.bool()[:, None, None, :]
    q3, k3, v3 = t((8, 16, 1024, 64), 0.125), t((8, 16, 1024, 64), 1.0), t((8, 16, 1024, 64), 1.0)
    cases = (
        ("flash_attention_relkey_1pass", flash_attention_relkey, (q, k, v, E, mask),
         lambda tf: flash_attention_relkey_plain(q, k, v, E, mask, tf32=tf), None),
        ("flash_attention_norel_1pass", flash_attention_relkey, (q2, k2, v2, None, mask2),
         lambda tf: flash_attention_relkey_plain(q2, k2, v2, None, mask2, tf32=tf),
         lambda: F.scaled_dot_product_attention(q2, k2, v2, attn_mask=keep2)),
        ("flash_attention_plain_f32_1pass", flash_attention_plain, (q3, k3, v3),
         lambda tf: noncausal_attention_plain(q3, k3, v3, tf32=tf),
         lambda: F.scaled_dot_product_attention(q3, k3, v3, scale=1.0)),
    )
    res, failures = {}, []
    for name, op, args, twin, lib in cases:
        n3, n1 = op.launches, op.launches_1pass
        out = op(*args, precision="default")
        torch.cuda.synchronize()
        if (op.launches - n3, op.launches_1pass - n1) != (0, 1):
            failures.append(f"{name}: precision='default' launched {op.launches - n3} 3-pass "
                            f"and {op.launches_1pass - n1} one-pass kernels, expected 0 and 1")
        ref = twin(True)
        err = (out - ref).abs().max().item()
        gate = ONEPASS_SHARE * ref.abs().max().item()
        dist_f32 = (out - twin(False)).abs().max().item()
        del out, ref
        ms = cuda_ms(lambda: op(*args, precision="default"), reps=9)
        ms_3pass = cuda_ms(lambda: op(*args, precision="highest"), reps=9)
        plain_ms = cuda_ms(lambda: twin(True), reps=5)
        library_ms = backend = None
        if lib is not None:
            with tf32_numerics(True):
                library_ms = cuda_ms(lib, reps=9)
                backend = top_kernel(lib)
        Bx, Hx, Tx, _ = args[0].shape
        P = 0 if len(args) < 4 or args[3] is None else args[3].shape[0]
        flops = (4 * Tx * Tx + 2 * Tx * P) * 64 * Bx * Hx
        moved = 4 * nbytes(args[0]) + (0 if P == 0 else nbytes(args[3])) + (
            nbytes(args[4]) if len(args) > 4 else 0)
        res[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                         **bound(flops, moved, "tf32"), ms_3pass=ms_3pass, dist_f32=dist_f32,
                         library_backend=backend)
        say(f"[3g] {name} [{Bx}, {Hx}, {Tx}, 64] f32"
            + (", E [73, 64]" if P else "") + (", masked" if len(args) > 4 else "")
            + f": max|kernel-TF32 twin| {err:.3e} (gate {gate:.3e})  max|kernel-f32 twin| "
              f"{dist_f32:.3e}  one pass {ms:.4f} ms  3xTF32 {ms_3pass:.4f} ms  twin "
              f"{plain_ms:.3f} ms"
            + ("" if lib is None else f"  SDPA (TF32 on) {library_ms:.4f} ms [{backend}]")
            + f"  bound {res[name]['bound_ms']:.4f} ms ({res[name]['bound_by']}, "
              f"{100 * res[name]['bound_ms'] / ms:.1f} % of it)")
        if not err <= gate:
            failures.append(f"{name} differs from its TF32 twin by {err} > {gate}")
    if failures:
        raise AssertionError("one-pass kernels: " + "; ".join(failures))
    return res


def _mimi_elu_pad(dev, B):
    """4g's elu_pad: every launch of one Mimi forward, zero mode, f32."""
    say(f"[4g] elu_pad zero mode: every launch of one Mimi forward at B={B}: shape, pads, "
        f"residual, elu, keep written; GB, kernel ms, share of 3.35 TB/s, twin ms")
    total = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bytes": 0}
    largest = None
    for i, (C, T, layout, (left, right), has_res, elu, keep) in enumerate(MIMI_ELU_PAD_LAUNCHES):
        x = _elu_pad_input(dev, B, C, T, layout, torch.float32, 100 + 2 * i)
        r = _elu_pad_input(dev, B, C, T, 0, torch.float32, 101 + 2 * i) if has_res else None
        n0 = elu_pad.launches
        out = elu_pad(x, left, right, residual=r, elu=elu, keep_input=True, pad_mode="constant")
        ref = elu_pad_plain(x, left, right, r, elu, keep_input=True, pad_mode="constant")
        torch.cuda.synchronize()
        if elu_pad.launches != n0 + 1:
            raise AssertionError(f"elu_pad launched {elu_pad.launches - n0} times")
        if not (torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])):
            raise AssertionError(f"elu_pad's zero mode differs from its twin at Mimi launch {i}: "
                                 f"[{B}, {C}, {T}], pads ({left}, {right})")
        written = keep and out[1] is not x
        moved = 4 * B * C * (T * (1 + has_res + written) + T + left + right)
        del out, ref

        def run(fn):
            return fn(x, left, right, r, elu, keep, pad_mode="constant")

        ms = cuda_ms(lambda: run(elu_pad))
        plain_ms = cuda_ms(lambda: run(elu_pad_plain))
        b = bound(0, moved, "f32")
        say(f"[4g]   {str([B, C, T]):16s} ({left}, {right}) {int(has_res)} {int(elu)} "
            f"{int(written)}: {moved / 1e9:.3f} GB  kernel {ms:.4f} ms  "
            f"{100 * b['bound_ms'] / ms:.1f} %  twin {plain_ms:.4f} ms")
        for key, val in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", b["bound_ms"]),
                         ("bytes", moved)):
            total[key] += val
        if largest is None or moved >= largest[3]:
            largest = (ms, plain_ms, b, moved)
        del x, r
        torch.cuda.empty_cache()
    ms, plain_ms, b, moved = largest
    say(f"[4g] elu_pad zero mode: largest launch {moved / 1e9:.3f} GB in {ms:.4f} ms "
        f"({100 * b['bound_ms'] / ms:.1f} % of 3.35 TB/s, twin {plain_ms:.4f} ms); the forward's "
        f"{len(MIMI_ELU_PAD_LAUNCHES)} launches {total['bytes'] / 1e9:.3f} GB in "
        f"{total['ms']:.4f} ms ({100 * total['bound_ms'] / total['ms']:.1f} %, twin "
        f"{total['plain_ms']:.4f} ms)")
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=None, **b,
                **{f"{k}_forward": total[k] for k in ("ms", "plain_ms", "bound_ms")})


def _mimi_window(dev, B, cfg):
    """4g's window kernel at the forward's shape, beside its twin and SDPA
    given the band as a boolean ``attn_mask``."""
    H, T, dh, W = cfg.num_attention_heads, 750, cfg.head_dim, cfg.sliding_window
    q, k, v = (_randn(dev, (B, H, T, dh), torch.float32, 200 + i) for i in range(3))
    idx = torch.arange(T, device=dev)
    band = (idx[None, :] <= idx[:, None]) & (idx[None, :] > idx[:, None] - W)  # [T (q), T (k)]
    n0 = flash_attention_window.launches
    out = flash_attention_window(q, k, v, W)
    torch.cuda.synchronize()
    if flash_attention_window.launches != n0 + 1:
        raise AssertionError("flash_attention_window did not launch its kernel")
    err = (out - flash_attention_window_plain(q, k, v, W)).abs().max().item()
    lib = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=band)  # noqa: E731
    lib_err = (out - lib()).abs().max().item()
    del out
    ms = device_ms(lambda: flash_attention_window(q, k, v, W))
    plain_ms = device_ms(lambda: flash_attention_window_plain(q, k, v, W), n=5)
    library_ms = device_ms(lib)
    backend = top_kernel(lib)
    pairs = sum(min(i + 1, W) for i in range(T))  # (query, key) pairs in the band, a head
    flops, moved = 4 * dh * pairs * B * H, 4 * nbytes(q)
    b = bound(flops, moved, "tf32x3")
    say(f"[4g] window attention [{B}, {H}, {T}, {dh}], window {W} ({pairs} pairs a head): "
        f"max|kernel-plain| {err:.3e}  max|kernel-SDPA| {lib_err:.3e}  kernel {ms:.4f} ms  "
        f"plain {plain_ms:.4f} ms  SDPA (boolean band, TF32 off) {library_ms:.4f} ms "
        f"({backend[:60]})  bound {b['bound_ms']:.4f} ms ({b['bound_by']}; "
        f"{100 * b['bound_ms'] / ms:.1f} %)")
    if not err <= KERNEL_ATOL:
        raise AssertionError(f"the window kernel differs from its plain version by {err}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                library_max_abs_err=lib_err, **b,
                bound_f32_ms=bound(flops, moved, "f32")["bound_ms"])


def _mimi_rvq(dev, B, cfg):
    """4g's K3 at D = 256: the forward's two launches (1 semantic, 31
    acoustic codebooks of 2048 x 256) over its 375 code frames a row."""
    C, D, rows = cfg.codebook_size, cfg.codebook_dim, B * 375
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    split = rvq_plan(rows, sms, 128)
    x = _randn(dev, (B, 375, D), torch.float32, 300, 2.0)
    res = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": None, "agreement": 1.0}
    flops = moved = 0
    for S in (cfg.num_semantic_quantizers, cfg.num_quantizers - cfg.num_semantic_quantizers):
        cb = _randn(dev, (S, C, D), torch.float32, 301 + S)
        n0 = rvq_encode.launches
        out = rvq_encode(cb, x, S)
        torch.cuda.synchronize()
        if rvq_encode.launches != n0 + 1:
            raise AssertionError("rvq_encode did not launch K3")
        ref = rvq_encode_plain(cb, x, S)
        agree = (out == ref).float().mean().item()
        recon = lambda c: sum(cb[j][c[:, j]] for j in range(S))  # noqa: E731,B023
        err = (recon(out.long()) - recon(ref.long())).abs().max().item()
        ms = cuda_ms(lambda: rvq_encode(cb, x, S))  # noqa: B023
        plain_ms = cuda_ms(lambda: rvq_encode_plain(cb, x, S))  # noqa: B023
        f, m = 2 * rows * S * C * D, 2 * nbytes(x) + nbytes(cb, out)
        b = bound(f, m, "tf32x3")
        say(f"[4g] K3 rvq {S} x {C} x {D} over [{B}, 375, {D}] (split {split}): code agreement "
            f"{agree:.6f}  max|recon diff| {err:.3e}  kernel {ms:.3f} ms  plain {plain_ms:.3f} ms  "
            f"bound {b['bound_ms']:.3f} ms in 3xTF32 ({100 * b['bound_ms'] / ms:.1f} %)")
        if not agree >= RVQ_AGREEMENT:
            raise AssertionError(f"K3 at D = {D} agrees with its plain version at {agree}")
        res["max_abs_err"] = max(res["max_abs_err"], err)
        res["agreement"] = min(res["agreement"], agree)
        res["ms"] += ms
        res["plain_ms"] += plain_ms
        flops, moved = flops + f, moved + m
        del cb, out, ref
    b = bound(flops, moved, "tf32x3")
    say(f"[4g] K3 at D = {D}, both launches: kernel {res['ms']:.3f} ms  plain "
        f"{res['plain_ms']:.3f} ms  bound {b['bound_ms']:.3f} ms ({100 * b['bound_ms'] / res['ms']:.1f} %)")
    return {**res, **b, "bound_f32_ms": bound(flops, moved, "f32")["bound_ms"]}


def phase4g_mimi(dev, B=32):
    """Mimi's encode path: its three kernels at the shapes of one B x 30 s
    forward against their plain twins (``elu_pad``'s zero mode bit for bit,
    the window kernel within KERNEL_ATOL, K3 at D = 256 by code agreement),
    each timed beside its twin with its bound; then ``AudioToken``'s Mimi
    encoder at published widths, 8 and 32 rows of 30 s, with every count
    zeroed just before a forward: one window launch a layer,
    ``MIMI_RVQ_LAUNCHES`` of K3, one ``elu_pad`` for each entry of
    ``MIMI_ELU_PAD_LAUNCHES``, and neither K1 nor K2. Returns (launches a
    forward, the kernels line's entries)."""
    cfg = MimiConfig()
    with get_policy("highest").numerics():
        res = {"elu_pad_zero": _mimi_elu_pad(dev, B), "flash_attention_window":
               _mimi_window(dev, B, cfg), "rvq_d256": _mimi_rvq(dev, B, cfg)}
    torch.cuda.empty_cache()

    at = AudioToken(Tokenizers.mimi, num_codebooks=cfg.num_quantizers, weights="random",
                    device=dev)
    at.load_encoder()
    enc = at.encoder
    rng = np.random.default_rng(9)
    pcm = (rng.standard_normal((B, 30 * SR)) * 3000).clip(-32768, 32767).astype(np.int16)
    enc(pcm[:8])  # warm up cuDNN's algorithm choice and the allocator
    torch.cuda.synchronize()
    want = {"flash_attention_window": cfg.num_hidden_layers, "rvq_encode": MIMI_RVQ_LAUNCHES,
            "elu_pad": len(MIMI_ELU_PAD_LAUNCHES), "seanet_front": 0, "lstm_layer": 0}
    counted = (flash_attention_window, rvq_encode, elu_pad, seanet_front, lstm_layer)
    for rows in sorted({min(8, B), B}):
        for kern in counted:
            kern.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        codes = enc(pcm[:rows])
        torch.cuda.synchronize()
        got = {k.__name__: k.launches for k in counted}
        if got != want:
            raise AssertionError(f"a Mimi forward at B={rows} launched {got}, expected {want}")
        if codes.shape != (rows, cfg.num_quantizers, 375) or codes.dtype != np.int16:
            raise AssertionError(f"Mimi codes {codes.shape} {codes.dtype}")
        if codes.min() < 0 or codes.max() >= cfg.codebook_size:
            raise AssertionError(f"Mimi codes outside [0, {cfg.codebook_size})")
    peak = torch.cuda.max_memory_allocated(dev)
    say(f"[4g] Mimi forward at B={min(8, B)} and {B} x 30 s: launches {got} (counts zeroed before each); "
        f"peak {peak / 2**30:.2f} GiB at B={B}")
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc(pcm)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    say(f"[4g] MimiEncoder B={B} x 30 s int16: median wall {wall * 1e3:.1f} ms (runs "
        f"{', '.join(f'{w * 1e3:.1f}' for w in walls)}), RTFx {B * 30.0 / wall:.1f}")
    say(f"[4g] MimiEncoder B={B} profiled: {device_split(lambda: enc(pcm))}")
    del at, enc
    torch.cuda.empty_cache()
    counts = {"flash_attention_window": want["flash_attention_window"],
              "rvq_encode_d256": want["rvq_encode"], "elu_pad_zero": want["elu_pad"]}
    return counts, res


def phase4h_linear(dev, M=LINEAR_ROWS):
    """``linear_3xtf32`` at each (K, N) of a semantic_m forward over ``M``
    rows: its error against float64 beside cuBLAS IEEE SGEMM's, its time
    beside its twin and cuBLAS, its bound; then the forward's launches
    summed. Returns the kernels line's entry."""
    total = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "max_ratio": 0.0}
    flops = moved = 0
    for K, N, per in LINEAR_SHAPES:
        x = _randn(dev, (M, K), torch.float32, 400 + K)
        w = _randn(dev, (N, K), torch.float32, 401 + N, K ** -0.5)
        b = _randn(dev, (N,), torch.float32, 402)
        ref = F.linear(x.double(), w.double(), b.double())
        n0 = linear_3xtf32.launches
        err = (linear_3xtf32(x, w, b).double() - ref).abs().max().item()
        torch.cuda.synchronize()
        if linear_3xtf32.launches != n0 + 1:
            raise AssertionError("linear_3xtf32 did not launch its kernel")
        lib = lambda: F.linear(x, w, b)  # noqa: E731,B023
        lib_err = (lib().double() - ref).abs().max().item()
        del ref
        ms = device_ms(lambda: linear_3xtf32(x, w, b))  # noqa: B023
        plain_ms = device_ms(lambda: linear_3xtf32_twin(x, w, b), n=5)  # noqa: B023
        library_ms = device_ms(lib)
        f, m = 2 * M * N * K, nbytes(x, w, b) + 4 * M * N
        bd = bound(f, m, "tf32x3")
        say(f"[4h] linear_3xtf32 [{M}, {K}] x [{N}, {K}]^T ({per} a forward): max|kernel-f64| "
            f"{err:.3e}, cuBLAS IEEE {lib_err:.3e} (ratio {err / lib_err:.2f})  kernel {ms:.3f} ms "
            f"({f / ms / 1e9:.1f} TFLOP/s)  twin {plain_ms:.3f} ms  cuBLAS IEEE {library_ms:.3f} ms "
            f"({top_kernel(lib)[:60]})  bound {bd['bound_ms']:.3f} ms ({bd['bound_by']}; "
            f"{100 * bd['bound_ms'] / ms:.1f} %)")
        if not err <= LINEAR_ERR_RATIO * lib_err:
            raise AssertionError(f"linear_3xtf32 at K={K} N={N}: error {err} above "
                                 f"{LINEAR_ERR_RATIO} x cuBLAS's {lib_err}")
        for key, v in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", library_ms)):
            total[key] += per * v
        total["max_ratio"] = max(total["max_ratio"], err / lib_err)
        flops, moved = flops + per * f, moved + per * m
        del x, w, b
    bd = bound(flops, moved, "tf32x3")
    say(f"[4h] a semantic_m forward's {LINEAR_LAUNCHES} linears at B=8 x 30 s: kernel "
        f"{total['ms']:.2f} ms ({flops / total['ms'] / 1e9:.1f} TFLOP/s)  twin "
        f"{total['plain_ms']:.2f} ms  cuBLAS IEEE {total['library_ms']:.2f} ms  bound "
        f"{bd['bound_ms']:.2f} ms ({100 * bd['bound_ms'] / total['ms']:.1f} %)")
    torch.cuda.empty_cache()
    return {**total, **bd, "bound_f32_ms": bound(flops, moved, "f32")["bound_ms"]}


def phase4d_semantic_s(dev, tmp):
    """The semantic_s entry points; returns K4's launch count, the facade
    (its seed-0 encoder is reused by phase 5d) and the default form's
    device RTFx at B=8."""
    rng = np.random.default_rng(10)
    clip90 = (0.2 * rng.standard_normal(90 * SR_M)).astype(np.float32)
    clip7 = (0.2 * rng.standard_normal(7 * SR_M + 123)).astype(np.float32)
    pcm30 = (rng.standard_normal((32, 30 * SR_M)) * 3000).clip(-32768, 32767).astype(np.int16)
    for name, clip in (("s90.wav", clip90), ("s7.wav", clip7)):
        write_wav(os.path.join(tmp, name), clip[None], SR_M)
    t0 = time.perf_counter()
    at = AudioToken(Tokenizers.semantic_s, weights="random", device=dev)
    at.load_encoder()
    default = at.encoder.model_cfg.attn_impl
    say(f"[4d] HubertEncoder built (random weights, seed 0, attn_impl={default!r}) in "
        f"{time.perf_counter() - t0:.1f} s")
    other = "xla" if default == "flash" else "flash"
    encs = {default: at.encoder,
            other: HubertEncoder(weights="random", seed=0, device=dev, attn_impl=other)}
    for enc in encs.values():
        enc(pcm30[:8])  # warm up cuBLAS, cuDNN's algorithm choice and the allocator
    torch.cuda.synchronize()

    reset_counts()
    flash_forwards = 0
    ids = at.encode(os.path.join(tmp, "s7.wav"))
    _check_ids(ids, (1, 1, feature_lengths(7 * SR_M + 123, at.encoder.model_cfg)))
    ids = at.encode(os.path.join(tmp, "s90.wav"), chunk_size=30)
    _check_ids(ids, (1, 1, 3 * 1499))
    flash_forwards += 4 if default == "flash" else 0
    walls = {}
    for attn, enc in encs.items():
        for B in (8, 32):
            torch.cuda.reset_peak_memory_stats(dev)
            runs = []
            for _ in range(3):
                ids, wall = _timed(lambda: enc(pcm30[:B]))
                runs.append(wall)
                flash_forwards += attn == "flash"
                _check_ids(ids, (B, 1, 1499))
            peak = torch.cuda.max_memory_allocated(dev) / 2**30
            walls[attn, B] = statistics.median(runs)
            say(f"[4d] HubertEncoder attn_impl={attn!r} B={B} x 30 s int16: median wall "
                f"{walls[attn, B] * 1e3:.1f} ms (runs {', '.join(f'{w * 1e3:.1f}' for w in runs)}), "
                f"RTFx {B * 30.0 / walls[attn, B]:.1f}, peak device memory {peak:.2f} GiB")
    for B in (8, 32):
        fast = min(encs, key=lambda a: walls[a, B])
        say(f"[4d] B={B}: {fast!r} is the faster form ({walls['flash', B] * 1e3:.1f} ms flash, "
            f"{walls['xla', B] * 1e3:.1f} ms xla); the default is {default!r}")
    n = flash_attention_relkey.launches
    say(f"[4d] K4 launches during the semantic_s main path: {n} over {flash_forwards} "
        f"'flash' forwards")
    if n != HUBERT_LAYERS * flash_forwards or n < 1:
        raise AssertionError(f"K4 launched {n} times, expected {HUBERT_LAYERS} x {flash_forwards}")
    del encs
    return n, at, 8 * 30.0 / walls[default, 8]


def phase5d_semantic_s_goldens(dev, tmp, at, keep):
    """The semantic_s golden gate; ``keep`` gets each seed's encoder and
    battery line (for phase 5f)."""
    g = np.load(os.path.join(parity.GOLD, "battery_semantic_s.npz"))
    audio, lengths, names = battery(SR_M)
    audio = ladder.hubert_host_norm(audio, lengths)
    failures = []
    for seed in WEIGHT_SEEDS:
        enc = keep.setdefault("encs", {})[seed] = (
            at.encoder if seed == 0
            else HubertEncoder(weights="random", seed=seed, device=dev))
        ids = enc(audio, attention_mask=lengths)
        ref = g[f"ids_s{seed}"]
        per_case = (ids.reshape(len(names), -1) == ref.reshape(len(names), -1)).mean(axis=1)
        keep.setdefault("lines", {})[seed] = per_case
        for name, agree in zip(names, per_case):
            thresh = parity.case_thresh("semantic_s", name)
            ok = agree >= thresh
            say(f"[5d] battery s{seed:<2d} {name:14s} agreement {agree:.6f} (>= {thresh}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"s{seed} {name} {agree:.6f}")

    g = np.load(os.path.join(parity.GOLD, "api_semantic_s.npz"))
    for name, wav in api_clips(SR_M, at.encoder.buckets).items():
        if name == "multichunk_90s":
            path = os.path.join(tmp, "api_s90.wav")
            write_wav(path, (np.clip(wav, -1, 1) * 32767.0).astype(np.int16)[None], SR_M)
            toks = at.encode(path, chunk_size=30.0)
        else:
            toks = at.encode(wav[None].astype(np.float32))
        ref = g[f"tokens_{name}"]
        agree = float((toks == ref).mean()) if toks.shape == ref.shape else 0.0
        ok = agree >= parity.THRESH
        say(f"[5d] api {name:14s} agreement {agree:.6f} (>= {parity.THRESH}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"api {name} {agree:.6f}")
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError("semantic_s golden gate failed: " + "; ".join(failures))

PHASE_OF = {"acoustic": "5", "semantic_m": "5b", "semantic_s": "5d"}


def phase5f_precision_ladder(dev, tok, keep):
    """The precision ladder over ``keep``'s encoders (one a weight seed, from
    the golden phase of ``tok``), and its gates; returns the ladder and the
    launch counts of the phase."""
    t_phase = time.perf_counter()
    names = CASE_NAMES
    encs = keep["encs"]
    torch.cuda.synchronize()
    reset_counts()
    k4 = None if tok == "acoustic" else (
        lambda: {"3xTF32": flash_attention_relkey.launches,
                 "one pass": flash_attention_relkey.launches_1pass,
                 "linear_3xtf32": linear_3xtf32.launches})
    lad = ladder.run_ladder(tok, encs, batches=(8, 32), say=say, tag="[5f]", counts=k4)
    kernels = ACOUSTIC_KERNELS if tok == "acoustic" else (flash_attention_relkey,)
    counts = {k.__name__: k.launches for k in kernels}
    if k4:
        counts["flash_attention_relkey_1pass"] = flash_attention_relkey.launches_1pass
    say(f"[5f] {tok}: kernel launches during the ladder: {counts}")
    failures = [f"{name} was not launched" for name, n in counts.items() if n < 1]
    for mode, res in lad.items() if k4 else ():
        # one pass where the attention kernel's precision is DEFAULT (or HIGH)
        n = res["launches"]
        onepass = mode in ONEPASS_MODES
        ok = (n["one pass"] > 0 and n["3xTF32"] == 0) if onepass else (
            n["3xTF32"] > 0 and n["one pass"] == 0)
        # semantic_m's linears take the 3xTF32 GEMM exactly where K4 takes 3xTF32
        ok &= (n["linear_3xtf32"] > 0) == (tok == "semantic_m" and not onepass)
        say(f"[5f] {tok} {mode:8s}: K4 and linear launches {n} ({'one pass' if onepass else '3xTF32'} "
            f"expected) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{mode} launched K4 {n}")
    exact = ladder.exact_cases(tok, names)
    for seed in encs:
        line = lad["highest"]["lines"][seed]
        if not np.array_equal(line, keep["lines"][seed]):
            failures.append(f"highest s{seed}: {line} != phase {PHASE_OF[tok]}'s "
                            f"{keep['lines'][seed]}")
        if "mixed" in lad:
            mixed = lad["mixed"]["lines"][seed]
            moved = [names[i] for i in exact if mixed[i] != line[i]]
            same_ids = all(np.array_equal(lad["mixed"]["ids"][seed][i],
                                          lad["highest"]["ids"][seed][i]) for i in exact)
            say(f"[5f] {tok} mixed s{seed}: exactness rows equal to highest's: "
                f"{'yes' if not moved else 'no, ' + ', '.join(moved)}; ids equal: {same_ids}")
            if moved:
                failures.append(f"mixed s{seed} differs from highest on {moved}")
    for mode, res in lad.items():
        worst = min(s["worst"][1] for s in res["summary"].values())
        probes = [s["probes"] for s in res["summary"].values() if s["probes"] is not None]
        below = sum(len(s["below"]) for s in res["summary"].values())
        say(f"[5f] {tok} {mode:8s}: worst exactness row {worst:.6f} over "
            f"{len(encs)} seeds" + (f", probes {min(probes):.6f}-{max(probes):.6f}"
                                    if probes else "")
            + f", {below} seed-cases below the contract, RTFx "
            + " / ".join(f"{r:.1f}" for r in res["rtfx"].values()) + " at B="
            + " / ".join(map(str, res["rtfx"])))
    failures += _check_buckets(dev, tok, encs)
    say(f"[5f] {tok} phase wall {time.perf_counter() - t_phase:.1f} s")
    if failures:
        raise AssertionError(f"precision ladder ({tok}) failed: " + "; ".join(failures))
    return lad, counts


def _check_buckets(dev, tok, encs):
    """``buckets=`` on the card: seed 0's encoder built on a grid of one 12 s
    bucket pads the battery's 8 s rows (which the default grid leaves
    unpadded) to it, and gives the ids the default grid gives the rows
    zero-padded to 12 s by hand: the same input, one a bucket of each grid.
    (semantic_s's GroupNorm runs over the padding, as the reference's does,
    so its ids depend on the bucket; the golden agreement is printed.)
    -> failures."""
    audio, lengths, names, golden = ladder.battery_inputs(tok)
    grid = (12 * ladder.SAMPLE_RATE[tok],)
    enc = type(encs[0])(weights="random", seed=0, device=dev, buckets=grid)
    out, n_frames = enc.dispatch(audio, None if tok == "acoustic" else lengths)
    ids = ladder.encode_battery(tok, enc, audio, lengths)
    by_hand = np.pad(audio, ((0, 0), (0, grid[0] - audio.shape[-1])))
    ref = ladder.encode_battery(tok, encs[0], by_hand, lengths)[..., :ids.shape[-1]]
    below = ladder.below_contract(tok, names, ladder.agreement(ids, golden["ids_s0"]))
    same = np.array_equal(ids, ref)
    say(f"[5f] {tok} buckets={grid}: {out.shape[-1]} frames padded against {n_frames}; ids "
        f"equal to the default grid's on the rows padded by hand: {same}; against the "
        f"golden, below the contract: {', '.join(below) or 'none'}")
    del enc
    torch.cuda.empty_cache()
    failures = [] if same else [f"buckets={grid}: ids differ from the hand-padded rows'"]
    if out.shape[-1] <= n_frames:
        failures.append(f"buckets={grid} did not pad: {out.shape[-1]} frames")
    return failures


class _SynchronousEncoder:
    """``enc`` whose ``dispatch`` waits for the device and returns host ids."""

    def __init__(self, enc):
        self.enc, self.device = enc, enc.device
        self.host_transform = enc.host_transform
        self.accepts_int16 = enc.accepts_int16
        self.int16_device_transform = enc.int16_device_transform

    def dispatch(self, audio, lengths):
        ids, n_frames = self.enc.dispatch(audio, lengths)
        torch.cuda.synchronize()
        return ids.cpu(), n_frames


def _npy_files(out):
    return sorted(f for f in os.listdir(out) if f.endswith(".npy"))


def _check_corpus_output(tag, out, expected, ref, archives=0):
    """Every expected file written once, of the expected token count, equal
    to ``ref`` bit for bit; the manifest holds each file, and each of the
    ``archives`` tars, once."""
    if _npy_files(out) != sorted(expected):
        raise AssertionError(f"{tag}: wrote {_npy_files(out)}, expected {sorted(expected)}")
    with open(os.path.join(out, "manifest.json")) as f:
        manifest = json.load(f)["completed"]
    if len(manifest) != len(set(manifest)) or len(manifest) != len(expected) + archives:
        raise AssertionError(f"{tag}: manifest of {len(manifest)} entries for "
                             f"{len(expected)} files and {archives} archives")
    bad = []
    for name, frames in expected.items():
        tok = np.load(os.path.join(out, name))
        # a last chunk under 0.2 s is dropped by the corpus path, not by
        # encode(path): its tokens are the reference's tail past ``frames``
        want = ref[name][:, :frames]
        if tok.shape[1:] != (frames,) or tok.dtype != np.int16:
            bad.append(f"{name} {tok.shape} {tok.dtype}, expected [K, {frames}] int16")
        elif want.shape != tok.shape or not np.array_equal(tok, want):
            agree = float((tok == want).mean()) if want.shape == tok.shape else 0.0
            bad.append(f"{name} agreement {agree:.6f} ({want.shape} reference)")
    if bad:
        raise AssertionError(f"{tag}: " + "; ".join(bad))


def _rerun_writes_nothing(tag, at, B, out, audio_dir):
    mtimes = {f: os.path.getmtime(os.path.join(out, f)) for f in _npy_files(out)}
    summary = at.encode_batch_files(batch_size=B, outdir=out, chunk_size=30, audio_dir=audio_dir)
    if summary["batches"] != 0 or mtimes != {f: os.path.getmtime(os.path.join(out, f))
                                             for f in _npy_files(out)}:
        raise AssertionError(f"{tag}: the rerun wrote {summary['batches']} batches")


def _corpus_run(tag, at, B, out, audio_dir, device_rtfx, num_workers=4):
    summary, wall, busy, gaps = corpus.corpus_run(at, B, out, audio_dir, num_workers)
    if "failed_files" in summary:
        raise AssertionError(f"{tag}: failed files {summary['failed_files']}")
    lines, _nums = corpus.report(tag, summary, wall, busy, gaps, device_rtfx, B)
    for line in lines:
        say(f"[4e] {line}")


def phase4e_corpus(dev, tmp, seed, device_rtfx):
    """The corpus path on the card: acoustic at B=8 and 32, then semantic_s
    at B=8. ``device_rtfx`` holds phase 4's AcousticEncoder RTFx by batch
    and, under "semantic_s", phase 4d's HubertEncoder RTFx at B=8. Returns
    the corpus (:func:`profile_corpus_torch.make_corpus`)."""
    t0 = time.perf_counter()
    c = corpus.make_corpus(seed, tmp)
    say(f"[4e] corpus (seed {seed}): {len(c['sources'])} files, {c['seconds']:.1f} s of audio "
        f"({c['seconds'] / 60:.1f} min), written at 24 and 16 kHz in "
        f"{time.perf_counter() - t0:.1f} s")

    at = AudioToken(Tokenizers.acoustic, num_codebooks=16, weights="random", device=dev)
    at.load_encoder()
    t0 = time.perf_counter()
    ref = {name: at.encode(path, chunk_size=30)[0] for name, path in c["sources"].items()}
    say(f"[4e] reference: AudioToken.encode(path, chunk_size=30) of every file in "
        f"{time.perf_counter() - t0:.1f} s")
    launches = {}
    for B in (8, 32):
        out = os.path.join(tmp, f"corpus_tokens_b{B}")
        reset_counts()
        _corpus_run(f"acoustic B={B}", at, B, out, c["dir"], device_rtfx[B])
        for kern in ACOUSTIC_KERNELS:
            launches[kern.__name__] = launches.get(kern.__name__, 0) + kern.launches
        _check_corpus_output(f"acoustic B={B}", out, c["frames"], ref, archives=1)
        _rerun_writes_nothing(f"acoustic B={B}", at, B, out, c["dir"])
    say("[4e] acoustic B=8 profiled: " + device_split(lambda: at.encode_batch_files(
        batch_size=8, outdir=os.path.join(tmp, "corpus_tokens_prof"), chunk_size=30,
        audio_dir=c["dir"])))
    say("[4e] every file written once, token counts right, tokens equal to "
        "AudioToken.encode(path, chunk_size=30) at both batches; the reruns wrote nothing")
    del at, ref
    torch.cuda.empty_cache()

    sem = AudioToken(Tokenizers.semantic_s, weights="random", device=dev)
    sem.load_encoder()
    sem.encoder(np.zeros((8, 30 * SR_M), np.int16))  # warm up cuDNN and cuBLAS
    out, out_sync = os.path.join(tmp, "corpus16_tokens"), os.path.join(tmp, "corpus16_sync")
    reset_counts()
    # one producer thread, so that both runs see the same batches
    _corpus_run("semantic_s B=8", sem, 8, out, c["dir16"], device_rtfx["semantic_s"],
                num_workers=1)
    launches["flash_attention_relkey"] = flash_attention_relkey.launches
    executor.encode_batch_files(_SynchronousEncoder(sem.encoder), sem.model_config,
                                batch_size=8, outdir=out_sync, chunk_size=30, num_workers=1,
                                audio_dir=c["dir16"])
    ref = {name: np.load(os.path.join(out_sync, name)) for name in _npy_files(out_sync)}
    _check_corpus_output("semantic_s B=8", out, c["frames16"], ref)
    say("[4e] semantic_s: every file written once, ids equal to the synchronous dispatch's")
    say(f"[4e] kernel launches during the corpus phase: {launches}")
    for name, n in launches.items():
        if n < 1:
            raise AssertionError(f"kernel {name} was not launched by the corpus path")
    del sem
    torch.cuda.empty_cache()
    return c


def phase5e_corpus_goldens(dev, tmp):
    """The acoustic battery's _i16 rows as PCM16 files through the corpus."""
    g = np.load(os.path.join(parity.GOLD, "battery_acoustic.npz"))
    audio, lengths, names = battery(SR)
    rows = [i for i, name in enumerate(names) if name.endswith("_i16")]
    d = os.path.join(tmp, "battery_i16")
    os.makedirs(d)
    for i in rows:
        # the rows are int16 values over 2^15 already: this recovers them exactly
        pcm = np.round(audio[i, : lengths[i]].astype(np.float64) * 32768.0).astype(np.int16)
        write_wav(os.path.join(d, f"{names[i]}.wav"), pcm[None], SR)
    failures = []
    for seed in WEIGHT_SEEDS:
        at = AudioToken(Tokenizers.acoustic, num_codebooks=16, weights="random", seed=seed,
                        device=dev)
        out = os.path.join(tmp, f"battery_i16_tokens_s{seed}")
        at.encode_batch_files(batch_size=8, outdir=out, chunk_size=30, audio_dir=d)
        ref = g[f"ids_s{seed}"]
        for i in rows:
            tok = np.load(os.path.join(out, f"{names[i]}.npy"))
            m = -(-int(lengths[i]) // 320)  # the causal encoder's tokens of the valid prefix
            agree = float((tok == ref[i][:, :m]).mean()) if tok.shape == (16, m) else 0.0
            thresh = parity.case_thresh("acoustic", names[i])
            ok = agree >= thresh
            say(f"[5e] battery s{seed:<2d} {names[i]:14s} through the corpus: agreement "
                f"{agree:.6f} (>= {thresh}) {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"s{seed} {names[i]} {agree:.6f}")
        del at
    if failures:
        raise AssertionError("corpus golden gate failed: " + "; ".join(failures))


def encodec_state_dict(tree):
    """The inverse of ``convert/encodec.py``: an acoustic parameter tree ->
    the HF ``EncodecModel`` (24 kHz) state dict, numpy. Each conv weight is
    split into weight norm's ``original0`` = ||w|| over dims (1, 2) and
    ``original1`` = w (the refold rounds a weight by at most one ulp); the
    LSTM weights and codebooks go as they are, with the codebook buffers
    the HF model carries beside them."""
    sd = {}

    def conv(prefix, p):
        w = np.ascontiguousarray(np.asarray(p["kernel"], np.float32).transpose(2, 1, 0))
        g = np.sqrt((w.astype(np.float64) ** 2).sum(axis=(1, 2), keepdims=True))
        sd[f"{prefix}.conv.bias"] = np.asarray(p["bias"], np.float32)
        sd[f"{prefix}.conv.parametrizations.weight.original0"] = g.astype(np.float32)
        sd[f"{prefix}.conv.parametrizations.weight.original1"] = w

    def lstm(prefix, p):
        for i, layer in enumerate(p["layers"]):
            for name, key in (("wih", "weight_ih"), ("whh", "weight_hh"), ("bih", "bias_ih"),
                              ("bhh", "bias_hh")):
                sd[f"{prefix}.lstm.{key}_l{i}"] = np.asarray(layer[name], np.float32)

    def res(prefix, p):
        conv(f"{prefix}.block.1", p["conv1"])
        conv(f"{prefix}.block.3", p["conv2"])
        if "shortcut" in p:
            conv(f"{prefix}.shortcut", p["shortcut"])

    enc, dec = tree["encoder"], tree["decoder"]
    conv("encoder.layers.0", enc["conv_in"])
    idx = 1
    for stage in enc["stages"]:
        for r in stage["res"]:
            res(f"encoder.layers.{idx}", r)
            idx += 1
        conv(f"encoder.layers.{idx + 1}", stage["down"])  # after the ELU
        idx += 2
    lstm(f"encoder.layers.{idx}", enc["lstm"])
    conv(f"encoder.layers.{idx + 2}", enc["conv_out"])  # after the LSTM and an ELU
    conv("decoder.layers.0", dec["conv_in"])
    lstm("decoder.layers.1", dec["lstm"])
    idx = 2
    for stage in dec["stages"]:
        conv(f"decoder.layers.{idx + 1}", stage["up"])  # after the ELU
        idx += 2
        for r in stage["res"]:
            res(f"decoder.layers.{idx}", r)
            idx += 1
    conv(f"decoder.layers.{idx + 1}", dec["conv_out"])
    for k, cb in enumerate(np.asarray(tree["codebooks"], np.float32)):
        pre = f"quantizer.layers.{k}.codebook"
        sd[f"{pre}.inited"] = np.ones(1, np.float32)
        sd[f"{pre}.cluster_size"] = np.ones(cb.shape[0], np.float32)
        sd[f"{pre}.embed"] = cb
        sd[f"{pre}.embed_avg"] = cb.copy()
    return sd


def nanogpt_state_dict(tree):
    """The inverse of ``convert/gpt.py``: a GPT parameter tree -> a nanoGPT
    state dict behind torch.compile's ``_orig_mod.`` prefix (linears
    [out, in], no entry for an absent bias), numpy."""
    sd = {}

    def put(name, p, kernel=None):
        w = p["scale"] if kernel is None else np.ascontiguousarray(np.asarray(p[kernel]).T)
        sd[f"_orig_mod.{name}.weight"] = np.asarray(w, np.float32)
        if p.get("bias") is not None:
            sd[f"_orig_mod.{name}.bias"] = np.asarray(p["bias"], np.float32)

    sd["_orig_mod.transformer.wte.weight"] = np.asarray(tree["wte"], np.float32)
    sd["_orig_mod.transformer.wpe.weight"] = np.asarray(tree["wpe"], np.float32)
    put("transformer.ln_f", tree["ln_f"])
    for i, layer in enumerate(tree["layers"]):
        pre = f"transformer.h.{i}"
        put(f"{pre}.ln_1", layer["ln1"])
        put(f"{pre}.attn.c_attn", layer["attn"]["qkv"], "kernel")
        put(f"{pre}.attn.c_proj", layer["attn"]["out"], "kernel")
        put(f"{pre}.ln_2", layer["ln2"])
        put(f"{pre}.mlp.c_fc", layer["mlp"]["in"], "kernel")
        put(f"{pre}.mlp.c_proj", layer["mlp"]["out"], "kernel")
    return sd


def _torch_save(sd, path, wrap=False):
    sd = {k: torch.from_numpy(v) for k, v in sd.items()}
    torch.save({"model": sd, "iter_num": 0} if wrap else sd, path)


def _same_tree(a, b):
    fa, fb = _flatten(a), _flatten(b)
    return fa.keys() == fb.keys() and all(
        (fa[k] is None and fb[k] is None)
        or (fa[k] is not None and fb[k] is not None and np.array_equal(fa[k], fb[k]))
        for k in fa)


def phase6a_converters(dev, tmp, ref_ids):
    """Upstream-format checkpoints built from the seed-0 random trees,
    converted two ways: ``weights="artifacts"`` from a staged
    ``$AUDIOTOKEN_ARTIFACTS``, and ``cli convert`` -> ``weights=<dir>``.
    ``ref_ids``: phase 5's seed-0 battery codes from ``weights="random"``."""
    t_phase = t0 = time.perf_counter()
    art, store = os.path.join(tmp, "artifacts"), os.path.join(tmp, "store")
    os.makedirs(art)
    acoustic_src = os.path.join(art, "encodec_24khz.pt")
    tree = get_acoustic_params("random", 0)
    _torch_save(encodec_state_dict(tree), acoustic_src)
    gpt_src = os.path.join(art, "hubert_semantic_acoustic_gpt_en.pt")
    gpt_tree, _ = get_semantic_gpt_params("random", 0, "gpt_semantic_s_en",
                                          GPTConfig().vocab_size)
    _torch_save(nanogpt_state_dict(gpt_tree), gpt_src, wrap=True)
    say(f"[6a] HF-named EnCodec and _orig_mod. nanoGPT checkpoints written in "
        f"{time.perf_counter() - t0:.1f} s")

    saved = os.environ.get("AUDIOTOKEN_ARTIFACTS")
    os.environ["AUDIOTOKEN_ARTIFACTS"] = art
    try:
        audio, _lengths, names = battery(SR)
        reset_counts()
        at = AudioToken(Tokenizers.acoustic, num_codebooks=16, weights="artifacts", device=dev)
        at.load_encoder()
        ids_art = at.encoder(audio)
        counts = {k.__name__: k.launches for k in ACOUSTIC_KERNELS}
        del at
        gpt_art, _ = get_semantic_gpt_params("artifacts", 0, "gpt_semantic_s_en",
                                             GPTConfig().vocab_size)
    finally:
        if saved is None:
            del os.environ["AUDIOTOKEN_ARTIFACTS"]
        else:
            os.environ["AUDIOTOKEN_ARTIFACTS"] = saved
    say(f"[6a] kernel launches of AudioToken(acoustic, weights='artifacts') on the battery: "
        f"{counts}")
    for name, n in counts.items():
        if n < 1:
            raise AssertionError(f"kernel {name} was not launched from the converted weights")

    t0 = time.perf_counter()
    cli.main(["convert", "--model", "acoustic", "--src", acoustic_src, "--out", store])
    cli.main(["convert", "--model", "gpt_semantic_s_en", "--src", gpt_src, "--out", store])
    say(f"[6a] cli convert of both into {sorted(os.listdir(store))} in "
        f"{time.perf_counter() - t0:.1f} s")
    for name in ("acoustic", "gpt_semantic_s_en"):
        validate_tree(load_params(os.path.join(store, f"{name}.npz")), name)
    validate_tree(gpt_art, "gpt_semantic_s_en")
    if not (_same_tree(gpt_art, gpt_tree)
            and _same_tree(load_params(os.path.join(store, "gpt_semantic_s_en.npz")), gpt_tree)):
        raise AssertionError("the converted GPT differs from the tree its checkpoint came from")
    at = AudioToken(Tokenizers.acoustic, num_codebooks=16, weights=store, device=dev)
    at.load_encoder()
    ids_cli = at.encoder(audio)
    del at
    if not np.array_equal(ids_art, ids_cli):
        raise AssertionError("weights='artifacts' and cli convert -> weights=<dir> disagree")
    per_case = (ids_art.reshape(len(names), -1) == ref_ids.reshape(len(names), -1)).mean(axis=1)
    failures = []
    for name, agree in zip(names, per_case):
        thresh = parity.case_thresh("acoustic", name)
        if agree < thresh:
            failures.append(f"{name} {agree:.6f} < {thresh}")
    say(f"[6a] stores validated against the manifests; both routes' codes equal bit for bit; "
        f"against weights='random' per case {' '.join(f'{a:.6f}' for a in per_case)}; the "
        f"GPT's converted tree equals its source tree")
    if failures:
        raise AssertionError("converted acoustic codes outside the contract: " + "; ".join(failures))
    torch.cuda.empty_cache()
    say(f"[6a] phase wall {time.perf_counter() - t_phase:.1f} s")


VQ_BATCH_VECTORS = 16_000
# one EMA step on the card against the CPU: assignments may flip on near
# ties (IEEE f32 sums in another order); rows no flip touches agree within
EMA_AGREEMENT = 0.999
EMA_REL = 1e-5


def _ema_step_card_vs_cpu(dev, state, x):
    """The same EMA step (the trained state, the same vectors) on the card
    and on the CPU -> (assignment agreement, max relative codebook
    difference over the rows that no flipped vector touches)."""
    cfg = VQTrainConfig()
    cpu_state = tuple(s.cpu() for s in state)
    new_dev, _ = _ema_update(state, x, cfg)
    new_cpu, _ = _ema_update(cpu_state, x.cpu(), cfg)
    with get_policy("highest").numerics():
        idx_dev = nearest_centroid(x, state[0]).cpu()
    idx_cpu = nearest_centroid(x.cpu(), cpu_state[0])
    flips = idx_dev != idx_cpu
    touched = torch.zeros(cfg.codebook_size, dtype=torch.bool)
    touched[idx_dev[flips]] = True
    touched[idx_cpu[flips]] = True
    cb_dev, cb_cpu = new_dev[0].cpu()[~touched], new_cpu[0][~touched]
    rel = ((cb_dev - cb_cpu).abs().max() / cb_cpu.abs().max()).item()
    return 1.0 - flips.float().mean().item(), rel, int(touched.sum())


def phase6b_quantizer(dev, tmp, c):
    """Quantizer training (semantic_m, EMA VQ 2048) over phase 4e's 16 kHz
    corpus in 10 s segments -> K4's row for the kernels line."""
    t_phase = time.perf_counter()
    outdir = os.path.join(tmp, "vq")
    files = sorted(os.listdir(c["dir16"]))
    reset_counts()
    t1 = train_quantizer("semantic_m", c["dir16"], outdir, batch_vectors=VQ_BATCH_VECTORS,
                         weights="random", device=dev)
    launches = flash_attention_relkey.launches
    st = t1.stats
    enc_s, setup_s = st["timers"].totals["encode"], st["timers"].totals["setup"]
    stream_s = st["wall_s"] - setup_s  # the corpus's wall after the weights are on the card
    with open(os.path.join(outdir, "processed_files.json")) as f:
        processed = json.load(f)["files"]
    say(f"[6b] train_quantizer(semantic_m, {len(files)} files, {c['seconds16']:.1f} s of audio, "
        f"batch_vectors {VQ_BATCH_VECTORS}): {t1.steps} steps, {st['vectors']} vectors trained "
        f"in {stream_s:.2f} s after a {setup_s:.2f} s set-up ({st['vectors'] / stream_s:.0f} "
        f"vectors/s), the encoder {enc_s:.2f} s ({100 * enc_s / stream_s:.1f} % of that wall), "
        f"updates "
        f"{st['timers'].totals['update']:.3f} s; K4 launched {launches} times; "
        f"{len(processed)} of {len(files)} files recorded as processed")
    if launches < W2V_BLOCKS or t1.steps < 1:
        raise AssertionError(f"quantizer training ran {t1.steps} steps, K4 {launches} launches")

    # the shape the path gives K4: a 10 s segment in its 12 s bucket
    enc = Wav2VecBertEncoder(weights="random", device=dev, quantize=False)
    clips = [read_wav(os.path.join(c["dir16"], f))[0][0] for f in files]
    pcm = np.stack([w[: 10 * SR_M] for w in clips if w.shape[-1] >= 10 * SR_M][:8])
    feats, n = enc.features(pcm)
    T = feats.shape[1]
    x = torch.cat(list(feats[:, :n])).float()
    del enc
    torch.cuda.empty_cache()
    rng = np.random.default_rng(6)

    def t(shape, scale):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)

    q, k, v, E = t((8, 16, T, 64), 0.3), t((8, 16, T, 64), 0.3), t((8, 16, T, 64), 1.0), \
        t((73, 64), 0.02)
    mask = torch.ones((8, T), device=dev)
    mask[:, n:] = 0.0  # the bucket's padding
    res = {}
    with get_policy("highest").numerics():
        for TT in (T, 500):
            qq, kk, vv = (a[:, :, :TT].contiguous() for a in (q, k, v))
            mm = mask[:, :TT].contiguous()
            out = flash_attention_relkey(qq, kk, vv, E, mm)
            err = (out - flash_attention_relkey_plain(qq, kk, vv, E, mm)).abs().max().item()
            ms = cuda_ms(lambda: flash_attention_relkey(qq, kk, vv, E, mm), reps=9)
            plain_ms = cuda_ms(lambda: flash_attention_relkey_plain(qq, kk, vv, E, mm), reps=9)
            say(f"[6b] K4 flash_attention_relkey [8, 16, {TT}, 64], masked to {min(n, TT)} "
                f"frames: max|kernel-plain| {err:.3e}  kernel {ms:.3f} ms  plain {plain_ms:.3f} ms")
            if not err <= KERNEL_ATOL:
                raise AssertionError(f"K4 at T={TT} differs from its plain version by {err}")
            flops = (4 * TT * TT + 2 * TT * E.shape[0]) * 64 * 8 * 16
            moved = 4 * 8 * 16 * TT * 64 * 4 + nbytes(E, mm)
            res[TT] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                           **bound(flops, moved, "tf32x3"),
                           bound_f32_ms=bound(flops, moved, "f32")["bound_ms"])
    del q, k, v

    agree, rel, touched = _ema_step_card_vs_cpu(dev, t1.state, x)
    say(f"[6b] one EMA step on {x.shape[0]} vectors, card against CPU: assignments agree "
        f"{agree:.6f} (>= {EMA_AGREEMENT}); codebook rows no flip touches ({2048 - touched}) "
        f"within {rel:.2e} of its scale (<= {EMA_REL})")
    if agree < EMA_AGREEMENT or not rel <= EMA_REL:
        raise AssertionError("the EMA step on the card disagrees with the CPU's")

    t2 = train_quantizer("semantic_m", c["dir16"], outdir, batch_vectors=VQ_BATCH_VECTORS,
                         weights="random", device=dev)
    with open(os.path.join(outdir, "processed_files.json")) as f:
        processed2 = json.load(f)["files"]
    untrained = st["segments"] - st["segments_trained"]
    say(f"[6b] second call on the same outdir: resumed at step {t2.steps}, read "
        f"{t2.stats['files_read']} files (the ones the first call did not train whole: "
        f"{len(files) - len(processed)}), encoded {t2.stats['segments']} segments (the first "
        f"call's untrained ones: {untrained} of {st['segments']}), {len(processed2)} recorded")
    if (t2.steps != t1.steps or t2.stats["files_read"] != len(files) - len(processed)
            or t2.stats["segments"] != untrained or processed2 != processed):
        raise AssertionError("quantizer training did not resume where it stopped")

    diag = compare_real_vs_random(x.cpu().numpy(), t1.codebook, device=dev)
    say(f"[6b] cluster diagnostics of the trained codebook: separation {diag['separation']:.3f} "
        f"(real p50 {diag['real']['p50']:.3f}, noise p50 {diag['random']['p50']:.3f}, "
        f"active {diag['real']['active_frac']:.3f})")
    del t1, t2, x
    torch.cuda.empty_cache()
    say(f"[6b] phase wall {time.perf_counter() - t_phase:.1f} s")
    return launches, res[T]


GPT_TRAIN_STEPS = 10
GPT_B, GPT_T = 8, 1024
# "default" (TF32 matmuls) against "highest" (IEEE f32) over the same steps:
# step 1's loss (at random init, where it sits near ln(53,376) at any
# precision), the largest gap of any step's loss, and the relative gap of
# the parameters' change, |d_default - d_highest| / |d_highest|. Each limit
# lies between TF32's reading and a bf16 forward's (H100 80GB HBM3, 700 W:
# 9.5e-7 / 4.8e-6, 1.4e-3 / 9.9e-2, 4.9e-3 / 3.0e-2); a bf16 forward must
# exceed one of them. 9.5e-7 is one f32 ulp of a loss of 11.
GPT_STEP1_ATOL = 3e-6
GPT_LOSS_ATOL = 1e-2
GPT_UPDATE_REL = 1.5e-2


def _gpt_steps(cfg, params, dev, idx, targets, precision, bf16=False, ref_delta=None):
    """``GPT_TRAIN_STEPS`` steps of a fresh ``TrainStep`` on one batch ->
    (the TrainStep, losses, walls, the parameters' change, or its relative
    gap to ``ref_delta``); ``bf16`` runs the steps under bf16 autocast."""
    ts = TrainStep(cfg, params=params, device=dev, precision=precision)
    start = [p.detach().clone() for p in ts.model.parameters()]
    losses, walls = [], []
    for _ in range(GPT_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.autocast("cuda", torch.bfloat16, enabled=bf16):
            losses.append(float(ts.step(idx, targets)))  # float() waits for the step
        walls.append(time.perf_counter() - t0)
    delta = torch.cat([(p.detach() - p0).flatten()
                       for p, p0 in zip(ts.model.parameters(), start)])
    del start
    if ref_delta is not None:
        delta = ((delta - ref_delta).norm() / ref_delta.norm()).item()
    return ts, losses, walls, delta


def phase6c_gpt_training(dev, tmp):
    """The GPT (12 x 768, block 1024, vocab 53,376) trained for
    ``GPT_TRAIN_STEPS`` steps on one fixed batch under "default", held
    against the same steps under "highest" (and a bf16 forward, which the
    check must catch); its store decodes the same greedy tokens as the model
    in memory."""
    t_phase = time.perf_counter()
    cfg = GPTConfig()
    params, _ = get_semantic_gpt_params("random", 0, "gpt_semantic_s_en", cfg.vocab_size)
    rng = np.random.default_rng(0)
    idx = rng.integers(0, cfg.vocab_size, (GPT_B, GPT_T))
    targets = np.roll(idx, -1, axis=1)
    targets[:, -1] = -1
    hi, loss_hi, _, delta_hi = _gpt_steps(cfg, params, dev, idx, targets, "highest")
    del hi
    _, loss_bf, _, rel_bf = _gpt_steps(cfg, params, dev, idx, targets, "default", bf16=True,
                                       ref_delta=delta_hi)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    ts, losses, walls, rel = _gpt_steps(cfg, params, dev, idx, targets, "default",
                                        ref_delta=delta_hi)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    del delta_hi
    step_s = statistics.median(walls[1:])
    gap = max(abs(a - b) for a, b in zip(losses, loss_hi))
    gap_bf = max(abs(a - b) for a, b in zip(loss_bf, loss_hi))
    say(f"[6c] TrainStep B={GPT_B} x T={GPT_T}, 'default': losses "
        f"{' '.join(f'{v:.4f}' for v in losses)}; median step {step_s * 1e3:.1f} ms (first "
        f"{walls[0] * 1e3:.1f}), {GPT_B * GPT_T / step_s:.0f} tokens/s, peak {peak:.2f} GiB")
    step1, step1_bf = abs(losses[0] - loss_hi[0]), abs(loss_bf[0] - loss_hi[0])
    say(f"[6c] against 'highest' over the {GPT_TRAIN_STEPS} steps: step 1 |loss gap| "
        f"{step1:.3e} (<= {GPT_STEP1_ATOL}), largest {gap:.3e} (<= {GPT_LOSS_ATOL}), "
        f"parameter change {rel:.3e} relative (<= {GPT_UPDATE_REL}); a bf16 forward: step 1 "
        f"{step1_bf:.3e}, largest {gap_bf:.3e}, parameter change {rel_bf:.3e}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the GPT's loss did not fall: {losses}")

    def within(s1, g, r):
        return s1 <= GPT_STEP1_ATOL and g <= GPT_LOSS_ATOL and r <= GPT_UPDATE_REL

    if not within(step1, gap, rel):
        raise AssertionError(f"training under 'default' left 'highest''s: step 1 {step1}, "
                             f"loss gap {gap}, parameter change {rel}")
    if within(step1_bf, gap_bf, rel_bf):
        raise AssertionError("the check against 'highest' passes a bf16 forward too")

    store = os.path.join(tmp, "gpt_store")
    tree = gpt_to_numpy(ts.model)
    validate_tree(tree, "gpt_semantic_s_en")
    save_params(os.path.join(store, "gpt_semantic_s_en.npz"), tree)
    loaded, lcfg = get_semantic_gpt_params(store, 0, "gpt_semantic_s_en", cfg.vocab_size)
    sampler = GPTSampler(_module_from_state(GPT, lcfg, gpt_from_numpy(loaded), dev,
                                            torch.float32))
    prompt = idx[0, :100]
    reset_counts()
    got = sampler.generate(prompt, max_new_tokens=64, top_k=1)
    counts = {k.__name__: k.launches for k in (decode_attention, decode_qkv, decode_ffn)}
    ref = GPTSampler(ts.model).generate(prompt, max_new_tokens=64, top_k=1)
    say(f"[6c] the trained GPT through gpt_to_numpy -> save_params -> weights=<dir>: greedy "
        f"tokens {'equal' if np.array_equal(got, ref) else 'DIFFERENT'} to the model in "
        f"memory's over 64 steps; kernel launches of the store's sampler: {counts}")
    if not np.array_equal(got, ref):
        raise AssertionError("the trained GPT's store decodes other greedy tokens")
    for name, n in counts.items():
        if n < 1:
            raise AssertionError(f"kernel {name} was not launched by the trained GPT's sampler")
    del ts, sampler
    torch.cuda.empty_cache()
    say(f"[6c] phase wall {time.perf_counter() - t_phase:.1f} s")
    return loss_hi

# --- phase 7: the mesh -------------------------------------------------------

MESH_RANKS = 2  # ranks of 7b/7c, two processes sharing the one card over gloo
MESH_TRAIN_STEPS = 3
# 7b's losses and 7c's features against world 1, under "highest": the
# shards sum the same products in another order (measured 1.9e-6 and
# 7.7e-6 on the H100), far below what a wrong shard moves
MESH_LOSS_ATOL = 1e-4
MESH_FEATURE_ATOL = 1e-4
MESH_TIMEOUT = 300.0  # seconds the spawned world may take


def _median_wall(fn, reps=3):
    """(median wall in s, last result) of ``fn`` over ``reps`` runs of
    :func:`_timed`."""
    runs = [_timed(fn) for _ in range(reps)]
    return statistics.median(wall for _, wall in runs), runs[-1][0]


def _collective_probe(dev):
    """Each collective the mesh layer calls, on a tensor of ``dev`` over the
    default group -> {op: "ok" or the error}."""
    import torch.distributed as dist

    x = torch.full((4,), float(dist.get_rank() + 1), device=dev)
    ops = {
        "all_reduce_sum": lambda: dist.all_reduce(x.clone()),
        "all_reduce_max": lambda: dist.all_reduce(x.clone(), op=dist.ReduceOp.MAX),
        "all_gather": lambda: dist.all_gather(
            [torch.empty_like(x) for _ in range(dist.get_world_size())], x),
    }
    res = {}
    for name, fn in ops.items():
        try:
            fn()
            res[name] = "ok"
        except (RuntimeError, ValueError) as e:
            res[name] = f"{type(e).__name__}: {str(e)[:100]}"
    return res


def _pcm8():
    """8 x 30 s of 24 kHz int16 noise, the batch phase 7 times."""
    x = np.random.default_rng(7).standard_normal((8, 30 * SR)) * 3000
    return x.clip(-32768, 32767).astype(np.int16)


def _semantic_m_ids(feats, codebook):
    """Conformer features -> VQ ids, as ``Wav2VecBertEncoder._forward``."""
    with torch.inference_mode(), get_policy("highest").numerics():
        f = F.layer_norm(feats, feats.shape[-1:], eps=1e-5)
        return nearest_centroid(f, codebook).to(torch.int16).cpu().numpy()


def phase7_rank(pcm_m, prompts, stop, corpus_dir, corpus_out):
    """One rank of 7b/7c/7e, on the card with its peer, over gloo: the dp=2
    acoustic encode of the battery, the tp=2 sampler on the golden prompts,
    TrainStep at (dp 1, tp 2) and (dp 2, tp 1), the tp=2 conformer on
    ``pcm_m``; then, after the kernel counts are read, K7's decode_ffn_tp
    against its plain version on the sampler's shard, and
    ``encode_batch_files`` of ``corpus_dir`` into ``corpus_out`` on the dp=2
    mesh. Returns its results, walls, shard shapes, kernel counts and that
    comparison."""
    from audiotoken_tpu_torch.configs import Wav2VecBertConfig, Wav2VecBertDecoderConfig
    from audiotoken_tpu_torch.nn.conformer import W2VBertConfig, W2VBertFeatures
    from audiotoken_tpu_torch.nn.fbank import FbankConfig, fbank_features
    from audiotoken_tpu_torch.parallel.mesh import make_mesh
    from audiotoken_tpu_torch.parallel.shard import conformer_param_spec, shard_tree
    from audiotoken_tpu_torch.weights import get_w2vbert_params, w2vbert_from_numpy

    out = {}
    with get_policy("highest").numerics():
        reset_counts()
        mesh = make_mesh(("dp",), device="cuda")
        dev = mesh.device
        out["gloo_cuda"] = _collective_probe(dev)
        enc = AcousticEncoder(weights="random", seed=0, device="cuda", mesh=mesh)
        audio, _lengths, _names = battery(SR)
        out["codes"] = enc(audio)
        pcm = _pcm8()
        enc(pcm)  # warm-up
        out["acoustic_wall"], _ = _median_wall(lambda: enc(pcm))
        del enc

        mesh = make_mesh(("dp", "tp"), (1, MESH_RANKS), device="cuda")
        dcfg = Wav2VecBertDecoderConfig
        params, gcfg = get_semantic_gpt_params("random", 0, dict(dcfg.model_artifacts)[
            COMMONS.HI], dcfg.vocab.vocab_size)
        model = _module_from_state(GPT, gcfg, gpt_from_numpy(params), dev, torch.float32)
        del params
        sampler = GPTSampler(model, mesh=mesh)
        del model
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out["tokens"] = sampler.generate_batch(prompts, max_new_tokens=96, temperature=0.8,
                                               top_k=1, stop_token=stop, seed=0)
        torch.cuda.synchronize()
        out["sampler_wall"] = time.perf_counter() - t0
        out["decode_steps"] = sampler.decode_steps
        out["sampler_shapes"] = {"qkv": tuple(sampler.model.layers[0].qkv.weight.shape),
                                 "heads": sampler.model.n_head,
                                 "wte": tuple(sampler.model.wte.shape)}
        layer0 = [None if t is None else t.detach().clone()
                  for t in sampler.model.decode_weights()[0]]
        del sampler
        torch.cuda.empty_cache()

        cfg = GPTConfig()
        params, _ = get_semantic_gpt_params("random", 0, "gpt_semantic_s_en", cfg.vocab_size)
        rng = np.random.default_rng(0)  # phase 6c's batch
        idx = rng.integers(0, cfg.vocab_size, (GPT_B, GPT_T))
        targets = np.roll(idx, -1, axis=1)
        targets[:, -1] = -1
        out["train"] = {}
        for shape in ((1, MESH_RANKS), (MESH_RANKS, 1)):
            mesh = make_mesh(("dp", "tp"), shape, device="cuda")
            ts = TrainStep(cfg, params=params, device="cuda", precision="highest", mesh=mesh)
            losses, walls = [], []
            for _ in range(MESH_TRAIN_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses.append(float(ts.step(idx, targets)))
                walls.append(time.perf_counter() - t0)
            out["train"][shape] = {"losses": losses, "walls": walls,
                                   "mlp_in": tuple(ts.model.layers[0].mlp_in.weight.shape)}
            del ts
            torch.cuda.empty_cache()
        del params

        mesh = make_mesh(("dp", "tp"), (1, MESH_RANKS), device="cuda")
        wcfg = Wav2VecBertConfig()
        tree, _codebook = get_w2vbert_params("random", 0, wcfg)
        local = shard_tree(tree, conformer_param_spec(tree), mesh, mesh.rank)
        del tree
        with torch.device("meta"):
            model = W2VBertFeatures(W2VBertConfig(), wcfg.output_layer, mesh.axis("tp"))
        model.load_state_dict(w2vbert_from_numpy(local, wcfg.output_layer), assign=True)
        model = model.to(dev).eval().requires_grad_(False)
        del local
        x = torch.from_numpy(pcm_m).to(dev).float() * (1.0 / 32768.0)
        mask = torch.ones(x.shape, device=dev)
        with torch.inference_mode():
            proc = fbank_features(x, mask, FbankConfig(), 2)
            fwd = lambda: model(proc["input_features"], proc["attention_mask"])  # noqa: E731
            fwd()
            k4_before = flash_attention_relkey.launches
            out["conformer_wall"], feats = _median_wall(fwd)
        out["conformer_forwards"] = 3
        out["k4_per_forward"] = (flash_attention_relkey.launches - k4_before) / 3
        out["features"] = feats.cpu().numpy()
        out["conformer_q"] = tuple(model.layers[0].attn.q.weight.shape)
    out["counts"] = {k.__name__: k.launches for k in KERNELS}
    out["ffn_tp_err"] = _ffn_tp_check(mesh.axis("tp"), layer0, len(prompts))
    with get_policy("highest").numerics():
        mesh = make_mesh(("dp",), device="cuda")
        at = AudioToken(Tokenizers.acoustic, num_codebooks=16, weights="random", device="cuda",
                        mesh=mesh)
        reset_counts()
        out["corpus"], out["corpus_wall"] = _timed(lambda: at.encode_batch_files(
            batch_size=8, outdir=corpus_out, chunk_size=30, audio_dir=corpus_dir))
        out["corpus_counts"] = {k.__name__: k.launches for k in ACOUSTIC_KERNELS}
    return out


def _corpus_mesh_report(outs, out_w1, out_gloo):
    """7e over the two gloo ranks: rank 0 alone wrote, every rank returned
    its summary and launched K1-K3, and each file within the acoustic
    per-case contract of the world-1 files, with the count of codes that
    differ -> failures."""
    failures = []
    if any(o["corpus"] != outs[0]["corpus"] for o in outs):
        failures.append("the ranks' corpus summaries differ")
    counts = [o["corpus_counts"] for o in outs]
    say(f"[7e] kernel launches of each rank in the corpus on the gloo mesh: {counts}")
    if min(min(c.values()) for c in counts) < 1:
        failures.append(f"a kernel did not launch on a rank in 7e: {counts}")
    names = _npy_files(out_w1)
    if _npy_files(out_gloo) != names:
        return failures + [f"7e wrote {len(_npy_files(out_gloo))} files, expected {len(names)}"]
    diff, bad = 0, []
    for name in names:
        a, b = np.load(os.path.join(out_gloo, name)), np.load(os.path.join(out_w1, name))
        agree = float((a == b).mean()) if a.shape == b.shape else 0.0
        diff += int((a != b).sum()) if a.shape == b.shape else b.size
        if agree < parity.case_thresh("acoustic", name):
            bad.append(f"{name} {agree:.6f}")
    s = outs[0]["corpus"]
    say(f"[7e] encode_batch_files on the dp=2 mesh of two gloo ranks sharing the card, B=8: "
        f"{len(names)} files written by rank 0, {s['batches']} batches broadcast; {diff} codes "
        f"differ from world 1 ({'bit-equal' if not diff else 'not bit-equal'}); per-file "
        f"acoustic contract {'ok' if not bad else 'FAIL ' + ', '.join(bad)}; RTFx of the two "
        f"processes {s['audio_seconds'] / outs[0]['corpus_wall']:.1f} (not a scaling figure); "
        f"mesh_send {s['stages'].get('mesh_send')}")
    return failures + [f"7e {b}" for b in bad]


def _ffn_tp_check(tp, weights, B):
    """K7's decode_ffn_tp with the all-reduce over ``tp`` on this rank's
    shard ``weights`` (a decode layer's, :meth:`GPT.decode_weights`) at
    ``B`` rows, against its plain version with the same all-reduce, in f32
    and bf16 -> {dtype: max |kernel - plain|}; raises past ``_compare``'s
    bound."""
    from audiotoken_tpu_torch.parallel.collectives import all_reduce

    _, _, _, _, wo, bo, ln_w, ln_b, wi, bi, w2, b2 = weights
    reduce = functools.partial(all_reduce, axis=tp)
    C, K = wo.shape
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        x = _randn(wo.device, (B, C), dt, 50)  # the residual stream: the same on every rank
        a = _randn(wo.device, (B, K), dt, 51 + tp.index)  # the rank's attention columns
        ws = [None if t is None else t.to(dt) for t in (wo, ln_w, ln_b, wi, w2, bo, bi, b2)]
        args = (x, a, *ws[:5], reduce, *ws[5:])
        errs[str(dt)] = _compare(f"K7 decode_ffn_tp, tp rank {tp.index}", decode_ffn_tp(*args),
                                 decode_ffn_tp_plain(*args), dt)
    return errs




def phase7_mesh(dev, tmp, ids_s0, m8, loss_hi, c):
    """The mesh: 7a world 1 over NCCL through the entry points' ``mesh=``;
    7b/7c two ranks on the card over gloo; 7d what they print; 7e the corpus
    executor on phase 4e's corpus ``c``, on the world-1 mesh and over the
    two ranks. Returns rank 0's launches of decode_ffn_tp on the tp=2
    sampler."""
    import torch.distributed as dist

    from audiotoken_tpu_torch.configs import Wav2VecBertDecoderConfig
    from audiotoken_tpu_torch.parallel.launch import run_world
    from audiotoken_tpu_torch.parallel.mesh import make_mesh

    t_phase = time.perf_counter()
    pcm_m, ids_m8 = m8
    dist.init_process_group("nccl", init_method=f"file://{tmp}/store7a", rank=0, world_size=1)
    try:
        mesh = make_mesh(("dp",))
        reset_counts()
        at = AudioToken(Tokenizers.acoustic, num_codebooks=16, weights="random", mesh=mesh)
        at.load_encoder()
        audio, _lengths, _names = battery(SR)
        codes = at.encoder(audio)
        same = np.array_equal(codes, ids_s0)
        pcm = _pcm8()
        at.encoder(pcm)
        wall_mesh, _ = _median_wall(lambda: at.encoder(pcm))
        at.encoder.mesh = None  # the same encoder without its mesh, for the comparison
        wall_plain, _ = _median_wall(lambda: at.encoder(pcm))
        at.encoder.mesh = mesh
        say(f"[7a] AudioToken(acoustic, mesh=make_mesh(('dp',))) on NCCL, world 1: battery "
            f"codes {'equal' if same else 'DIFFERENT'} to phase 5's seed 0; B=8 x 30 s int16 "
            f"RTFx {240 / wall_mesh:.1f} with the mesh, {240 / wall_plain:.1f} without")
        if not same:
            raise AssertionError("the acoustic battery through the mesh differs from phase 5")
        del at
        atm = AudioToken(Tokenizers.semantic_m, weights="random", mesh=mesh)
        atm.load_encoder()
        enc = atm.encoder
        ids = enc(pcm_m)
        same = np.array_equal(ids, ids_m8)
        wall_mesh, _ = _median_wall(lambda: enc(pcm_m))
        enc.mesh = None
        wall_plain, _ = _median_wall(lambda: enc(pcm_m))
        enc.mesh = mesh
        say(f"[7a] AudioToken(semantic_m, mesh=...) B=8 x 30 s int16: ids "
            f"{'equal' if same else 'DIFFERENT'} to phase 4b's; RTFx {240 / wall_mesh:.1f} with "
            f"the mesh, {240 / wall_plain:.1f} without")
        if not same:
            raise AssertionError("semantic_m through the mesh differs from phase 4b")
        counts = {k.__name__: k.launches for k in ACOUSTIC_KERNELS + (flash_attention_relkey,)}
        say(f"[7a] kernel launches through the mesh entry points: {counts}")
        if min(counts.values()) < 1:
            raise AssertionError(f"a kernel did not launch through the mesh entry points: "
                                 f"{counts}")
        feats1, _ = enc.features(pcm_m[:2])
        feats1 = feats1.float()
        ids1 = _semantic_m_ids(feats1, enc.codebook)
        codebook = enc.codebook
        del atm, enc
        torch.cuda.empty_cache()

        at = AudioToken(Tokenizers.acoustic, num_codebooks=16, weights="random", mesh=mesh)
        out_w1 = os.path.join(tmp, "corpus_mesh_w1")
        reset_counts()
        summary, wall = _timed(lambda: at.encode_batch_files(
            batch_size=8, outdir=out_w1, chunk_size=30, audio_dir=c["dir"]))
        counts = {k.__name__: k.launches for k in ACOUSTIC_KERNELS}
        ref_dir = os.path.join(tmp, "corpus_tokens_b8")
        same = _npy_files(out_w1) == _npy_files(ref_dir) and all(
            np.array_equal(np.load(os.path.join(out_w1, f)), np.load(os.path.join(ref_dir, f)))
            for f in _npy_files(ref_dir))
        say(f"[7e] encode_batch_files, acoustic on the world-1 mesh over NCCL, B=8: "
            f"{len(_npy_files(out_w1))} files {'bit-equal' if same else 'NOT equal'} to phase "
            f"4e's B=8 files; RTFx {summary['audio_seconds'] / wall:.1f}; kernel launches "
            f"{counts}")
        if not same:
            raise AssertionError("the corpus on the world-1 mesh differs from phase 4e's")
        if min(counts.values()) < 1:
            raise AssertionError(f"a kernel did not launch in the corpus on the mesh: {counts}")
        del at
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    say(f"[7a] phase wall {time.perf_counter() - t_phase:.1f} s")

    t0 = time.perf_counter()
    g = np.load(os.path.join(HERE, "tests", "torch_goldens", "decode_semantic_m_s0.npz"))
    vocab = Wav2VecBertDecoderConfig.vocab
    prompts = [p[p >= 0] for p in g["prompts"]]
    out_gloo = os.path.join(tmp, "corpus_mesh_gloo")
    outs = run_world("chip_smoke:phase7_rank", MESH_RANKS,
                     (pcm_m[:2], prompts, vocab.stop_token[COMMONS.ACOUSTIC], c["dir"], out_gloo),
                     backend="gloo", timeout=MESH_TIMEOUT)
    say(f"[7b] {MESH_RANKS} ranks on the one card over gloo in {time.perf_counter() - t0:.1f} s "
        f"(spawn included); gloo on CUDA tensors: {outs[0]['gloo_cuda']}")
    for r, o in enumerate(outs):
        refused = [op for op, v in o["gloo_cuda"].items() if v != "ok"]
        if refused:
            raise AssertionError(f"rank {r}: gloo refused {refused} on CUDA tensors")
    failures = []
    gold = np.load(os.path.join(parity.GOLD, "battery_acoustic.npz"))["ids_s0"]
    _audio, _lengths, names = battery(SR)
    for r, o in enumerate(outs):
        c = o["codes"]
        diff = int((c != ids_s0).sum())
        per_case = (c.reshape(len(names), -1) == gold.reshape(len(names), -1)).mean(axis=1)
        bad = [f"{n} {a:.6f}" for n, a in zip(names, per_case)
               if a < parity.case_thresh("acoustic", n)]
        say(f"[7b] rank {r}: dp=2 acoustic battery {c.shape}: {diff} codes differ from world 1 "
            f"({'bit-equal' if not diff else 'not bit-equal'}); per-case contract "
            f"{'ok' if not bad else 'FAIL ' + ', '.join(bad)}")
        failures += [f"rank {r} battery {b}" for b in bad]
    for r, o in enumerate(outs):
        rows = _ar_rows_gate(f"7b rank {r} tp=2", o["tokens"], g)
        failures += [f"rank {r} {f}" for f in rows]
        if not np.array_equal(o["tokens"], outs[0]["tokens"]):
            failures.append(f"rank {r}'s tokens differ from rank 0's")
    for shape in ((1, MESH_RANKS), (MESH_RANKS, 1)):
        for r, o in enumerate(outs):
            t = o["train"][shape]
            gap = max(abs(a - b) for a, b in zip(t["losses"], loss_hi))
            say(f"[7b] rank {r} TrainStep (dp {shape[0]}, tp {shape[1]}) B={GPT_B} x "
                f"T={GPT_T}, 'highest': losses {' '.join(f'{v:.6f}' for v in t['losses'])}, "
                f"largest gap to world 1 {gap:.3e} (<= {MESH_LOSS_ATOL}) "
                f"{'ok' if gap <= MESH_LOSS_ATOL else 'FAIL'}; mlp_in shard {t['mlp_in']}")
            if not gap <= MESH_LOSS_ATOL:
                failures.append(f"rank {r} train {shape} loss gap {gap:.3e}")

    feats = torch.from_numpy(outs[0]["features"]).to(dev)
    err = (feats - feats1).abs().max().item()
    ids_tp = _semantic_m_ids(feats, codebook)
    agree = float((ids_tp == ids1).mean())
    ok = agree >= parity.THRESH
    say(f"[7c] tp=2 conformer, 2 x 30 s semantic_m: features max |tp - world 1| {err:.3e} "
        f"(<= {MESH_FEATURE_ATOL}) {'ok' if err <= MESH_FEATURE_ATOL else 'FAIL'}; ids "
        f"agreement {agree:.6f} (>= {parity.THRESH}) {'ok' if ok else 'FAIL'}; q shard "
        f"{outs[0]['conformer_q']}")
    if not err <= MESH_FEATURE_ATOL:
        failures.append(f"tp conformer features {err:.3e} off world 1")
    if not ok:
        failures.append(f"tp conformer ids {agree:.6f}")
    if not np.array_equal(outs[1]["features"], outs[0]["features"]):
        failures.append("the tp ranks' conformer features differ")

    for r, o in enumerate(outs):
        n = o["counts"]
        steps = o["decode_steps"]
        say(f"[7d] rank {r} launches: K4 {n['flash_attention_relkey']} "
            f"({o['k4_per_forward']:.0f} a conformer forward), K6 {n['decode_attention']}, K7 "
            f"decode_qkv {n['decode_qkv']}, decode_ffn_tp {n['decode_ffn_tp']} (decode_ffn "
            f"{n['decode_ffn']}; {steps} decode steps); K1-K3 {n['seanet_front']}, "
            f"{n['lstm_layer']}, {n['rvq_encode']}; shards: sampler {o['sampler_shapes']} (K6's "
            f"cache holds the same heads); then K7 decode_ffn_tp with the all-reduce against "
            f"its plain version, max |kernel - plain| "
            + ", ".join(f"{dt} {e:.3e}" for dt, e in o["ffn_tp_err"].items()))
        for name in ("flash_attention_relkey", "decode_attention", "decode_qkv",
                     "decode_ffn_tp"):
            if n[name] < 1:
                failures.append(f"rank {r}: {name} was not launched")
        if o["k4_per_forward"] < W2V_BLOCKS:
            failures.append(f"rank {r}: K4 {o['k4_per_forward']} a forward < {W2V_BLOCKS}")
        tr = {s: statistics.median(o["train"][s]["walls"][1:]) for s in o["train"]}
        new = int((o["tokens"] >= 0).sum())
        say(f"[7d] rank {r}, two processes sharing one card (not a scaling figure): dp=2 "
            f"acoustic B=8 x 30 s (4 rows a rank) RTFx {240 / o['acoustic_wall']:.1f}; "
            f"tp=2 sampler {new / o['sampler_wall']:.1f} tokens/s over "
            f"{o['sampler_wall']:.2f} s; TrainStep "
            + ", ".join(f"(dp {a}, tp {b}) {w * 1e3:.0f} ms a step, "
                        f"{GPT_B * GPT_T / w:.0f} tokens/s" for (a, b), w in tr.items())
            + f"; tp=2 conformer 2 x 30 s RTFx {60 / o['conformer_wall']:.1f}")
    failures += _corpus_mesh_report(outs, out_w1, out_gloo)
    if failures:
        raise AssertionError("phase 7 failed: " + "; ".join(failures))
    say(f"[7] phase wall {time.perf_counter() - t_phase:.1f} s")
    return outs[0]["counts"]["decode_ffn_tp"]



def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of phase 4e's corpus")
    args = ap.parse_args()
    t_start = time.perf_counter()
    phase1_device()
    dev = torch.device("cuda", 0)
    phase2_build()
    with get_policy("highest").numerics():
        res = phase3_kernels(dev)
        res.update(phase3a_elu_pad(dev))
        res.update(phase3b_flash_attention(dev))
        res.update(phase3c_decode_kernels(dev))
        k8, k8_counts = phase3d_attn_ablation(dev)
        res.update(k8)
        res.update(phase3e_flash_norel(dev))
        k4_bf16_counts, k4_bf16 = phase3f_flash_bf16(dev)
        res.update(k4_bf16)
        res.update(phase3g_flash_onepass(dev))
    mimi_counts, mimi_res = phase4g_mimi(dev)
    res.update(mimi_res)
    res["linear_3xtf32"] = phase4h_linear(dev)
    with tempfile.TemporaryDirectory() as tmp:
        counts, device_rtfx = phase4_main_path(dev, tmp)
        keep = {}
        ids_s0 = phase5_goldens(dev, tmp, keep)
        phase5f_precision_ladder(dev, "acoustic", keep)
        del keep
        phase6a_converters(dev, tmp, ids_s0)
        counts["flash_attention_relkey"], counts["linear_3xtf32"], at, m8 = \
            phase4b_semantic_m(dev, tmp)
        keep = {}
        phase5b_semantic_m_goldens(dev, tmp, at, keep)
        _, c5f = phase5f_precision_ladder(dev, "semantic_m", keep)
        counts["flash_attention_relkey_1pass"] = c5f["flash_attention_relkey_1pass"]
        del at, keep
        torch.cuda.empty_cache()
        counts["flash_attention_norel"], at, device_rtfx["semantic_s"] = phase4d_semantic_s(
            dev, tmp)
        keep = {}
        phase5d_semantic_s_goldens(dev, tmp, at, keep)
        _, c5f = phase5f_precision_ladder(dev, "semantic_s", keep)
        counts["flash_attention_norel_1pass"] = c5f["flash_attention_relkey_1pass"]
        del at, keep
        torch.cuda.empty_cache()
        c = phase4e_corpus(dev, tmp, args.seed, device_rtfx)
        phase5e_corpus_goldens(dev, tmp)
        torch.cuda.empty_cache()
        counts["flash_attention_relkey_vq"], res["flash_attention_relkey_vq"] = \
            phase6b_quantizer(dev, tmp, c)
        loss_hi = phase6c_gpt_training(dev, tmp)
        counts["decode_ffn_tp"] = phase7_mesh(dev, tmp, ids_s0, m8, loss_hi, c)
    decode_counts = phase4c_decode(dev)
    counts["flash_attention_plain_f32_1pass"] = phase5c_decode_goldens(dev)
    say(f"[4c] K2 launches in the acoustic decoder: {decode_counts.pop('lstm_layer')}; "
        f"elu_pad: {decode_counts.pop('elu_pad')}")
    counts.update(decode_counts)
    counts.update(k4_bf16_counts)
    counts.update(mimi_counts)
    rows = [
        ("seanet_front", "seanet_front", "audiotoken_tpu_torch/csrc/seanet_front.cu",
         "audiotoken_tpu/ops/seanet_pallas.py:124"),
        ("lstm", "lstm_layer", "audiotoken_tpu_torch/csrc/lstm.cu",
         "audiotoken_tpu/ops/lstm_pallas.py:75"),
        ("rvq", "rvq_encode", "audiotoken_tpu_torch/csrc/rvq.cu",
         "audiotoken_tpu/ops/rvq_pallas.py:74"),
        # no TPU kernel: XLA fuses the ELU and the pad into each conv's operand
        ("elu_pad", "elu_pad", "audiotoken_tpu_torch/csrc/elu_pad.cu",
         "audiotoken_tpu/nn/seanet.py:119"),
        ("flash_attention_relkey", "flash_attention_relkey",
         "audiotoken_tpu_torch/csrc/flash_attention.cu",
         "audiotoken_tpu/ops/flash_attention.py:519"),
        ("flash_attention_plain", "flash_attention_plain",
         "audiotoken_tpu_torch/csrc/flash_attention_bf16.cu",
         "audiotoken_tpu/ops/flash_attention.py:287"),
        ("decode_attention", "decode_attention", "audiotoken_tpu_torch/csrc/decode_attention.cu",
         "audiotoken_tpu/ops/decode_attention.py:142"),
        ("decode_qkv", "decode_qkv", "audiotoken_tpu_torch/csrc/decode_step.cu",
         "audiotoken_tpu/ops/decode_step_fused.py:108"),
        ("decode_ffn", "decode_ffn", "audiotoken_tpu_torch/csrc/decode_step.cu",
         "audiotoken_tpu/ops/decode_step_fused.py:131"),
        # K7's decode_ffn again, split for tensor parallelism (phase 7's tp=2 sampler)
        ("decode_ffn_tp", "decode_ffn_tp", "audiotoken_tpu_torch/csrc/decode_step.cu",
         "audiotoken_tpu/ops/decode_step_fused.py:131"),
        # K4 again, in its no-rel masked form on the semantic_s path
        ("flash_attention_norel", "flash_attention_norel",
         "audiotoken_tpu_torch/csrc/flash_attention.cu",
         "audiotoken_tpu/ops/flash_attention.py:519"),
        # K4 again, at the 10 s segments (12 s bucket) of quantizer training
        ("flash_attention_relkey_vq", "flash_attention_relkey_vq",
         "audiotoken_tpu_torch/csrc/flash_attention.cu",
         "audiotoken_tpu/ops/flash_attention.py:519"),
        # K4's bf16 form, with the rel term and the mask, and with the mask alone
        ("flash_attention_relkey_bf16", "flash_attention_relkey_bf16",
         "audiotoken_tpu_torch/csrc/flash_attention_bf16.cu",
         "audiotoken_tpu/ops/flash_attention.py:519"),
        ("flash_attention_relkey_bf16_norel", "flash_attention_relkey_bf16_norel",
         "audiotoken_tpu_torch/csrc/flash_attention_bf16.cu",
         "audiotoken_tpu/ops/flash_attention.py:519"),
        # the one-pass forms (precision "high", "default", "bfloat16"): K4 on
        # 5f's semantic_m and semantic_s, K5 f32 on 5c's fine stage at "default"
        ("flash_attention_relkey_1pass", "flash_attention_relkey_1pass",
         "audiotoken_tpu_torch/csrc/flash_attention_tf32.cu",
         "audiotoken_tpu/ops/flash_attention.py:519"),
        ("flash_attention_norel_1pass", "flash_attention_norel_1pass",
         "audiotoken_tpu_torch/csrc/flash_attention_tf32.cu",
         "audiotoken_tpu/ops/flash_attention.py:519"),
        ("flash_attention_plain_f32_1pass", "flash_attention_plain_f32_1pass",
         "audiotoken_tpu_torch/csrc/flash_attention_tf32.cu",
         "audiotoken_tpu/ops/flash_attention.py:287"),
        # Mimi's encode path (4g), which the JAX package does not have: its
        # windowed attention, K3 at D = 256 and elu_pad's zero mode
        ("flash_attention_window", "flash_attention_window",
         "audiotoken_tpu_torch/csrc/flash_attention.cu", "none"),
        ("rvq_d256", "rvq_encode_d256", "audiotoken_tpu_torch/csrc/rvq.cu", "none"),
        ("elu_pad_zero", "elu_pad_zero", "audiotoken_tpu_torch/csrc/elu_pad.cu", "none"),
        # the semantic_m conformer's linears at highest (4h), which the JAX
        # package leaves to XLA; launches a forward
        ("linear_3xtf32", "linear_3xtf32", "audiotoken_tpu_torch/csrc/linear_3xtf32.cu", "none"),
    ]
    # the TPU script's ablations (:108), its one-pass kernel (:157), and for
    # full its baseline, the Pallas kernel of K5's tiled form
    k8_replaces = {"onepass": "scripts/profile_attn_micro.py:157",
                   "full": "audiotoken_tpu/ops/flash_attention.py:309"}
    for case in CASES:
        counts[f"attn_ablation_{case}"] = k8_counts[case]
        rows.append((f"attn_ablation_{case}", f"attn_ablation_{case}",
                     "audiotoken_tpu_torch/csrc/flash_attention_bf16.cu",
                     k8_replaces.get(case.rstrip("0123456789"),
                                     "scripts/profile_attn_micro.py:108")))
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[fn], **res[name]}
        for name, fn, src, rep in rows
    ]
    say(f"[done] every phase passed in {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
