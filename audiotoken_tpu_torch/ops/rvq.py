"""K3: residual-VQ encode over all active codebooks.

Counterpart of ``audiotoken_tpu/ops/rvq_pallas.py:rvq_encode_pallas``,
held against ``nn/rvq.py:rvq_encode`` of the JAX package. The CUDA kernel
is ``csrc/rvq.cu`` (3xTF32 products on the tensor cores, the argmax in their
epilogue); :func:`rvq_encode_plain` is the same function written the
direct way: per codebook a matmul, a first-index argmax and a gather.
:func:`rvq_plan` chooses how many blocks of a cluster split the codewords
when the row tiles are too few to fill the card. The kernel takes
codewords of 128 (EnCodec) or 256 (Mimi) dimensions.
"""

import functools

import torch

from . import _build


def rvq_encode_plain(codebooks: torch.Tensor, embeddings: torch.Tensor, num_q: int):
    """codebooks [K, C, D], embeddings [B, T, D] -> codes [B, num_q, T] int32.

    Distance ``-(|x|^2 - 2 x.e + |e|^2)``, ties to the first index (torch
    ``argmax``'s rule)."""
    B, T, D = embeddings.shape
    residual = embeddings.reshape(B * T, D).float()
    codes = []
    for k in range(num_q):
        cb = codebooks[k].float()
        x2 = (residual * residual).sum(-1, keepdim=True)
        xe = residual @ cb.t()
        e2 = (cb * cb).sum(-1)
        idx = torch.argmax(-(x2 - 2.0 * xe + e2), dim=-1)
        codes.append(idx)
        residual = residual - cb[idx]
    return torch.stack(codes).to(torch.int32).reshape(num_q, B, T).permute(1, 0, 2)


#: rows a block (4 warps of 16 at D = 128, 8 at D = 256) and the cluster
#: sizes that split the codewords (csrc/rvq.cu)
BLOCK_ROWS, SPLITS = 64, (1, 2, 4)
#: the kernel's entry and rows a block, by codeword dimension
_ENTRIES = {128: ("rvq_encode_f32", BLOCK_ROWS), 256: ("rvq_encode_d256_f32", 128)}


def rvq_plan(N: int, sms: int, block_rows: int = BLOCK_ROWS) -> int:
    """Blocks a cluster that split the codewords, for N rows on ``sms`` SMs
    in blocks of ``block_rows``: 4 under two row tiles an SM, 2 under
    eight, else 1. The fastest split at 8 of the 9 sizes from 1 to 32 rows
    of 30 s that ``scripts/profile_rvq_torch.py`` times on an H100 (D =
    128)."""
    tiles = -(-N // block_rows)
    return 4 if tiles < 2 * sms else 2 if tiles < 8 * sms else 1


def rvq_encode(codebooks: torch.Tensor, embeddings: torch.Tensor, num_q: int):
    """codebooks [K, C, D] f32, embeddings [B, T, D] f32 (D 128 or 256) ->
    codes [B, num_q, T] int32. Launches K3 for a CUDA tensor and runs
    :func:`rvq_encode_plain` for a CPU tensor."""
    if embeddings.device.type == "cpu":
        return rvq_encode_plain(codebooks, embeddings, num_q)
    if embeddings.device.type != "cuda":
        raise ValueError(f"rvq_encode: unsupported device {embeddings.device}")
    B, T, D = embeddings.shape
    block_rows = _ENTRIES[D][1] if D in _ENTRIES else BLOCK_ROWS
    codes = _launch(codebooks, embeddings, num_q,
                    rvq_plan(B * T, _sm_count(embeddings.device), block_rows))
    rvq_encode.launches += 1
    return codes


def _launch(codebooks, embeddings, num_q: int, split: int):
    """K3 with the codewords split over clusters of ``split`` blocks; every
    split gives the same bits (the profile and the card-only tests compare
    them). Counts no launch."""
    B, T, D = embeddings.shape
    K, C, _ = codebooks.shape
    if D not in _ENTRIES or C % 16 or not 1 <= num_q <= K or B * T < 1 or split not in SPLITS:
        raise ValueError(
            f"rvq_encode: embeddings {tuple(embeddings.shape)}, codebooks "
            f"{tuple(codebooks.shape)}, num_q {num_q}, split {split} (D must be one of "
            f"{sorted(_ENTRIES)}, C a multiple of 16, the split one of {SPLITS})"
        )
    dev = embeddings.device
    _build.check_tensor(embeddings, "embeddings", (B, T, D), torch.float32, dev,
                        vector_loads=True)
    _build.check_tensor(codebooks, "codebooks", (K, C, D), torch.float32, dev,
                        vector_loads=True)
    N = B * T
    e2 = (codebooks[:num_q] * codebooks[:num_q]).sum(-1).contiguous()
    codes = torch.empty((num_q, N), dtype=torch.int32, device=dev)
    _build.launch(_ENTRIES[D][0], dev, embeddings, codebooks, e2, codes, N, num_q, C, split)
    return codes.reshape(num_q, B, T).permute(1, 0, 2)


@functools.lru_cache(maxsize=None)
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


rvq_encode.launches = 0
