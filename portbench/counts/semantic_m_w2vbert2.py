"""Operations and bytes of the semantic_m tokenizer, from the shapes a call
runs, as the plain algorithm needs them.

An operation is a multiply or an add of a product: a linear of ``din`` ->
``dout`` over ``T`` frames is ``2 * T * din * dout``; attention over ``T``
frames, ``nh`` heads of ``dh``, is ``2 * T * T * dh`` for q k^T, the same
for p v, and ``2 * T * P * dh`` for q E^T (P relative positions), a head.
The fbank's power spectrum is counted as its 400 x 514 real product a
frame, the mel product as 257 x 80. Element-wise work (norms, softmax,
swish, GLU) is not counted, nor the frame of padding the program adds to
make the frames even. Bytes count each input read once and each
output written once, in f32.
"""


def _frames(cfg, n: int):
    fb = 1 + (n - cfg["frame_length"]) // cfg["hop_length"]
    return fb, fb // cfg["stride"]


def step_flops(cfg, path: str, lengths):
    """Operations of one encode call on rows ``lengths`` samples long:
    fbank, projection, ``output_layer`` conformer blocks, the VQ distances
    (None for decode, not counted yet)."""
    if path != "encode":
        return None
    return sum(_row_flops(cfg, int(n)) for n in lengths)


def _row_flops(cfg, n: int) -> float:
    fb, T = _frames(cfg, n)
    H, I, K = cfg["hidden_size"], cfg["intermediate_size"], cfg["conv_depthwise_kernel_size"]
    nh = cfg["num_attention_heads"]
    dh = H // nh
    P = cfg["left_max_position_embeddings"] + cfg["right_max_position_embeddings"] + 1
    n_fft2 = cfg["fft_length"] // 2 + 1
    fbank = 2 * fb * (cfg["frame_length"] * 2 * n_fft2 + n_fft2 * cfg["num_mel_bins"])
    proj = 2 * T * cfg["feature_projection_input_dim"] * H
    block = (2 * 2 * T * 2 * H * I  # two FFNs, in and out
             + 2 * T * 4 * H * H  # q, k, v, out
             + nh * (2 * 2 * T * T * dh + 2 * T * P * dh)  # attention
             + 2 * T * H * 2 * H + 2 * T * K * H + 2 * T * H * H)  # conv module
    vq = 2 * T * H * cfg["num_clusters"]
    return fbank + proj + cfg["output_layer"] * block + vq


def attention(cfg, path: str, lengths):
    """(operations, bytes) of kernel K4 in one encode call, every block: q
    k^T, q E^T and p v of every head over each row's own frames; reading q,
    k, v and the frame mask once a row and E once a block, writing the
    output once (None for decode)."""
    if path != "encode":
        return None
    H, nh = cfg["hidden_size"], cfg["num_attention_heads"]
    dh = H // nh
    P = cfg["left_max_position_embeddings"] + cfg["right_max_position_embeddings"] + 1
    n = cfg["output_layer"]
    flops = nbytes = 0
    for x in lengths:
        _, T = _frames(cfg, int(x))
        flops += n * nh * (2 * 2 * T * T * dh + 2 * T * P * dh)
        nbytes += n * 4 * (4 * nh * T * dh + T)
    return flops, nbytes + n * 4 * P * dh
