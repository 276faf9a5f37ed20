"""K3: residual-VQ encode over all active codebooks.

Counterpart of ``audiotoken_tpu/ops/rvq_pallas.py:rvq_encode_pallas``,
held against ``nn/rvq.py:rvq_encode`` of the JAX package. The CUDA kernel
is ``csrc/rvq.cu``; :func:`rvq_encode_plain` is the same function written
the direct way: per codebook a matmul, a first-index argmax and a gather.
"""

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


def rvq_encode(codebooks: torch.Tensor, embeddings: torch.Tensor, num_q: int):
    """codebooks [K, C, 128] f32, embeddings [B, T, 128] f32 -> codes
    [B, num_q, T] int32. Launches K3 for a CUDA tensor and runs
    :func:`rvq_encode_plain` for a CPU tensor."""
    if embeddings.device.type == "cpu":
        return rvq_encode_plain(codebooks, embeddings, num_q)
    if embeddings.device.type != "cuda":
        raise ValueError(f"rvq_encode: unsupported device {embeddings.device}")
    B, T, D = embeddings.shape
    K, C, _ = codebooks.shape
    if D != 128 or not 1 <= num_q <= K or B * T < 1:
        raise ValueError(
            f"rvq_encode: embeddings {tuple(embeddings.shape)}, codebooks "
            f"{tuple(codebooks.shape)}, num_q {num_q} (D must be 128)"
        )
    dev = embeddings.device
    _build.check_tensor(embeddings, "embeddings", (B, T, D), torch.float32, dev)
    _build.check_tensor(codebooks, "codebooks", (K, C, D), torch.float32, dev,
                        vector_loads=True)
    e2 = (codebooks[:num_q] * codebooks[:num_q]).sum(-1).contiguous()
    N = B * T
    codes = torch.empty((num_q, N), dtype=torch.int32, device=dev)
    _build.launch("rvq_encode_f32", dev, embeddings, codebooks, e2, codes, N, num_q, C)
    rvq_encode.launches += 1
    return codes.reshape(num_q, B, T).permute(1, 0, 2)


rvq_encode.launches = 0
