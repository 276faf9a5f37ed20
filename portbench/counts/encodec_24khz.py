"""Operations and bytes of EnCodec 24 kHz, from the shapes a call runs, as
the plain algorithm needs them.

An operation is a multiply or an add of a product: a conv or linear of
``c_in`` -> ``c_out`` channels, kernel ``k``, over ``L`` output positions
is ``2 * k * c_in * c_out * L``; a transposed conv over ``L`` input
positions the same with ``L`` the input length. Element-wise work (ELU,
the LSTM's gates, the biases) is not counted. Bytes count each input read
once and each output written once, in f32.
"""

import math


def _hop(cfg) -> int:
    return math.prod(cfg["upsampling_ratios"])


def _res(cfg, d: int, L: int) -> float:
    h = d // cfg["compress"]
    return 2 * L * (cfg["residual_kernel_size"] * d * h + h * d + d * d)


def _lstm_flops(cfg, rows: int, frames: int) -> float:
    """The whole stacked LSTM: input and recurrent products, every layer."""
    H = cfg["num_filters"] * 2 ** len(cfg["upsampling_ratios"])
    return cfg["num_lstm_layers"] * 2 * rows * frames * (4 * H * H) * 2


def encode_row(cfg, samples: int) -> float:
    """Operations to encode one row of ``samples`` (SEANet + RVQ)."""
    d, L = cfg["num_filters"], samples
    ops = 2 * L * cfg["kernel_size"] * cfg["audio_channels"] * d
    for r in reversed(cfg["upsampling_ratios"]):
        ops += _res(cfg, d, L)
        L = -(-L // r)
        ops += 2 * L * (2 * r) * d * (2 * d)
        d *= 2
    ops += _lstm_flops(cfg, 1, L)
    ops += 2 * L * cfg["last_kernel_size"] * d * cfg["hidden_size"]
    ops += 2 * L * cfg["encode_codebooks"] * cfg["codebook_size"] * cfg["codebook_dim"]
    return ops


def decode_row(cfg, frames: int) -> float:
    """Operations to decode one row of ``frames`` (SEANet decoder; the code
    lookup is gathers and adds)."""
    d = cfg["num_filters"] * 2 ** len(cfg["upsampling_ratios"])
    L = frames
    ops = 2 * L * cfg["kernel_size"] * cfg["hidden_size"] * d
    ops += _lstm_flops(cfg, 1, L)
    for r in cfg["upsampling_ratios"]:
        ops += 2 * L * (2 * r) * d * (d // 2)
        L *= r
        d //= 2
        ops += _res(cfg, d, L)
    ops += 2 * L * cfg["last_kernel_size"] * d * cfg["audio_channels"]
    return ops


def _frames(cfg, path: str, n: int) -> int:
    """The frames of a row ``n`` long (samples to encode, frames to decode)."""
    return -(-n // _hop(cfg)) if path == "encode" else n


def step_flops(cfg, path: str, lengths):
    """Operations of one call of the entry on rows ``lengths`` long
    (samples to encode, frames to decode)."""
    row = encode_row if path == "encode" else decode_row
    return sum(row(cfg, int(n)) for n in lengths)


def lstm(cfg, path: str, lengths):
    """(operations, bytes) of kernel K2 in one call: the recurrences of
    every layer (``h W_hh^T`` and the add of the input projection, 4H
    gates a step), reading the projected inputs [rows, frames, 4H] and
    W_hh once and writing the hidden states [rows, frames, H], f32."""
    H = cfg["num_filters"] * 2 ** len(cfg["upsampling_ratios"])
    steps, n = sum(_frames(cfg, path, int(x)) for x in lengths), cfg["num_lstm_layers"]
    flops = n * steps * (2 * 4 * H * H + 4 * H)
    nbytes = n * 4 * (steps * 4 * H + 4 * H * H + steps * H)
    return flops, nbytes
