"""The operation and byte counters against hand counts at small shapes, and
the whole-call counts against PyTorch's own count of the reference's
products at the configurations' widths."""

from types import SimpleNamespace

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import harness

ENCODEC = harness.load_module("counts", "encodec_24khz")
SEMANTIC = harness.load_module("counts", "semantic_m_w2vbert2")

#: a small EnCodec: hop 6, 8 LSTM units
TINY_ENCODEC = {"num_filters": 2, "upsampling_ratios": [2, 3], "audio_channels": 1,
                "kernel_size": 3, "last_kernel_size": 3, "residual_kernel_size": 3,
                "compress": 2, "num_lstm_layers": 1, "hidden_size": 4, "codebook_size": 5,
                "codebook_dim": 4, "encode_codebooks": 2, "sampling_rate": 6}
#: a small conformer: 8 wide, 2 heads of 4, FFN 16, 4 relative positions
TINY_SEMANTIC = {"hidden_size": 8, "num_attention_heads": 2, "intermediate_size": 16,
                 "conv_depthwise_kernel_size": 3, "left_max_position_embeddings": 2,
                 "right_max_position_embeddings": 1, "feature_projection_input_dim": 4,
                 "frame_length": 4, "hop_length": 2, "fft_length": 4, "num_mel_bins": 2,
                 "stride": 2, "sampling_rate": 10, "output_layer": 1, "num_clusters": 3}


def test_encodec_encode_by_hand():
    # conv_in 144; stage r=3: res 288, down 384; stage r=2: res 384, down 512;
    # LSTM 2048; conv_out 384; RVQ 160
    assert ENCODEC.encode_row(TINY_ENCODEC, 12) == 4304
    assert ENCODEC.step_flops(TINY_ENCODEC, "encode", [12, 12, 12]) == 3 * 4304


def test_encodec_decode_by_hand():
    # conv_in 384; LSTM 2048; r=2: up 512, res 384; r=3: up 384, res 288; conv_out 144
    assert ENCODEC.decode_row(TINY_ENCODEC, 2) == 4144
    assert ENCODEC.step_flops(TINY_ENCODEC, "decode", [2, 2]) == 2 * 4144
    # rows of their own lengths count apart: 6 samples, 1 frame
    assert ENCODEC.step_flops(TINY_ENCODEC, "decode", [2, 1]) == 4144 + ENCODEC.decode_row(TINY_ENCODEC, 1)


@pytest.mark.parametrize("path, lengths", [("encode", [12, 12]), ("decode", [2, 2])])
def test_lstm_by_hand(path, lengths):
    # 8 units, 2 rows x 2 frames, one layer: 4 steps of 2*4H*H + 4H;
    # bytes: inputs 2*2*32, W_hh 32*8, outputs 2*2*8 floats
    assert ENCODEC.lstm(TINY_ENCODEC, path, lengths) == (4 * (512 + 32), 4 * (128 + 256 + 32))


def test_semantic_by_hand():
    # 10 samples: 4 fbank frames, 2 stacked; fbank 240; projection 128;
    # block: FFNs 2048, q k v out 1024, attention 256, conv module 864; VQ 96
    assert SEMANTIC.step_flops(TINY_SEMANTIC, "encode", [10]) == 240 + 128 + 4192 + 96
    # q k^T and p v 64, q E^T 64, a head; q, k, v, out 4*2*2*4 floats, E 16, mask 2
    assert SEMANTIC.attention(TINY_SEMANTIC, "encode", [10]) == (256, 4 * (64 + 16 + 2))


def test_a_path_not_counted_reads_nothing():
    assert SEMANTIC.step_flops(TINY_SEMANTIC, "decode", [250]) is None
    assert SEMANTIC.attention(TINY_SEMANTIC, "decode", [250]) is None
    ctx = SimpleNamespace(cfg={**TINY_SEMANTIC, "dtype": "float32"}, path="decode",
                          counts=SEMANTIC, calls=[(0.0, 1.0, 1.0, [250])],
                          trace=SimpleNamespace(window_s=1.0), launches={})
    assert harness.load_module("metrics", "mfu_pct.decode", fallback=True).read(ctx) is None


def _roofline_ctx(flops, nbytes, kernel_s, dtype="float32"):
    counts = SimpleNamespace(work=lambda cfg, path, lengths: (flops * len(lengths), nbytes * len(lengths)))
    trace = SimpleNamespace(kernel_s=lambda match: kernel_s if match("k") else 0.0)
    return SimpleNamespace(cfg={"dtype": dtype}, path="encode", counts=counts, trace=trace,
                           calls=[(0.0, 1.0, 1.0, [1, 1])] * 2, launches={"k.launches": 4})


def test_roofline_share_is_bounded():
    from portbench.yardstick import PEAK_BYTES, PEAK_FLOPS, kernel_roofline_pct

    # two calls of two rows, each row at the peak for 0.25 s: 1 s of kernel time
    read = lambda ctx: kernel_roofline_pct(ctx, "work", "k", "k.launches")  # noqa: E731
    assert read(_roofline_ctx(PEAK_FLOPS["float32"] / 4, 0, 1.0)) == pytest.approx(100.0)
    assert read(_roofline_ctx(0, PEAK_BYTES / 4, 2.0, "bfloat16")) == pytest.approx(50.0)
    assert read(_roofline_ctx(1.0, 1.0, 0.0)) is None
    no_launch = _roofline_ctx(1.0, 1.0, 1.0)
    no_launch.launches = {}
    assert read(no_launch) is None


def _products(fn, *args):
    with FlopCounterMode(display=False) as fc:
        fn(*args)
    return fc.get_total_flops()


def test_encodec_counts_match_the_reference_products():
    cfg = harness.load_json("configs", "encodec_24khz")
    ref = harness.load_module("reference", "encodec_24khz")
    hop, rows, frames = 320, 2, 3
    w = ref.make_weights(cfg, {"path": "encode"}, 1, "cpu")
    enc = _products(ref.encode_latents, w["encoder"], cfg, torch.zeros(rows, frames * hop))
    rvq = rows * 2 * frames * cfg["encode_codebooks"] * cfg["codebook_size"] * cfg["codebook_dim"]
    assert ENCODEC.step_flops(cfg, "encode", [frames * hop] * rows) == enc + rvq
    w = ref.make_weights(cfg, {"path": "decode"}, 1, "cpu")
    dec = _products(ref.decode_waveform, w["decoder"], w["codebooks"], cfg,
                    torch.zeros(rows, cfg["decode_codebooks"], frames, dtype=torch.long))
    assert ENCODEC.step_flops(cfg, "decode", [frames] * rows) == dec


def test_semantic_counts_match_the_reference_products(narrow_semantic_m):
    cfg = {**harness.load_json("configs", "semantic_m_w2vbert2"), **narrow_semantic_m}
    ref = harness.load_module("reference", "semantic_m_w2vbert2")
    w = ref.make_weights(cfg, {"path": "encode"}, 1, "cpu")  # 48 fbank frames a row, 24 stacked
    got = _products(ref.features, w["encoder"], cfg, torch.zeros(2, 8000))
    fb = 48
    dft = 2 * fb * cfg["frame_length"] * 2 * (cfg["fft_length"] // 2 + 1)  # an FFT in the reference
    vq = 2 * 24 * cfg["hidden_size"] * cfg["num_clusters"]
    assert SEMANTIC.step_flops(cfg, "encode", [8000, 8000]) == got + 2 * (dft + vq)
