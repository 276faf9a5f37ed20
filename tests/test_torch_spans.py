"""The encoders' and decoders' trace spans (``runtime/profiling.py:span``),
on the CPU at full width on a tenth of a second of audio: under
``torch.profiler`` each call records its ``audiotoken.*`` steps, nested on
the calling thread; with no profiler recording no range is made."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from audiotoken_tpu_torch import AcousticDecoder, AcousticEncoder, AudioToken, Tokenizers
from audiotoken_tpu_torch.runtime.profiling import span


@pytest.fixture(scope="module")
def encoder():
    return AcousticEncoder(weights="random", seed=0, device="cpu", buckets=[3200])


@pytest.fixture(scope="module")
def facade():
    at = AudioToken(Tokenizers.acoustic, device="cpu", weights="random", num_codebooks=8)
    at.load_decoder()
    return at


def _pcm(n=2400, rows=2):
    return (np.random.default_rng(0).standard_normal((rows, n)) * 3000).astype(np.int16)


def _codes(T=10, rows=2):
    return np.random.default_rng(1).integers(0, 1024, size=(rows, 1, 8, T)).astype(np.int32)


def program_spans(fn):
    """Run ``fn`` under ``torch.profiler`` -> [(span, the program span that
    holds it or None)] in the order they opened."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    out = []
    for e in sorted(prof.events(), key=lambda e: e.time_range.start):
        if e.name.startswith("audiotoken."):
            p = e.cpu_parent
            while p is not None and not p.name.startswith("audiotoken."):
                p = p.cpu_parent
            out.append((e.name, None if p is None else p.name))
    return out


ENC = "audiotoken.encode"
DEC = "audiotoken.decode"


def test_encode_call_spans(encoder):
    assert program_spans(lambda: encoder(_pcm())) == [
        (ENC, None), (f"{ENC}.prepare", ENC), (f"{ENC}.upload", ENC),
        (f"{ENC}.forward", ENC), (f"{ENC}.download", ENC)]


def test_dispatch_spans_and_subbatches(encoder):
    """``dispatch`` has the call's children but the download; each
    sub-batch is a forward of its own."""
    assert program_spans(lambda: encoder.dispatch(_pcm())) == [
        (ENC, None), (f"{ENC}.prepare", ENC), (f"{ENC}.upload", ENC), (f"{ENC}.forward", ENC)]
    encoder.max_device_batch = 1
    try:
        names = [n for n, _ in program_spans(lambda: encoder(_pcm()))]
    finally:
        encoder.max_device_batch = 32
    assert names.count(f"{ENC}.forward") == 2 and names[-1] == f"{ENC}.download"


def test_decode_batch_spans(facade):
    """Each run of equal shapes is prepared, uploaded, decoded and
    downloaded inside the one call."""
    codes = list(_codes()) + [_codes(T=12, rows=1)[0]]
    got = program_spans(lambda: facade.decode_batch(codes))
    group = [(f"{DEC}.prepare", DEC), (f"{DEC}.upload", DEC), (f"{DEC}.forward", DEC),
             (f"{DEC}.download", DEC)]
    assert got == [(DEC, None)] + group + group


def test_decode_and_decoder_call_spans(facade):
    one = _codes(rows=1)[0]
    assert program_spans(lambda: facade.decode(one)) == [
        (DEC, None), (f"{DEC}.upload", DEC), (f"{DEC}.forward", DEC), (f"{DEC}.download", DEC)]
    dec = facade.decoder
    assert isinstance(dec, AcousticDecoder)
    assert program_spans(lambda: dec(one)) == [
        (DEC, None), (f"{DEC}.upload", DEC), (f"{DEC}.forward", DEC), (f"{DEC}.download", DEC)]


def test_no_range_without_a_profiler(encoder, facade, monkeypatch):
    """With no profiler recording, a span enters no ``record_function``."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    with span("audiotoken.test"):
        pass
    assert encoder(_pcm()).shape == (2, 16, 8)
    assert len(facade.decode_batch(list(_codes()))) == 2


def test_a_span_is_a_range_while_a_profiler_records():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("audiotoken.test"):
            torch.ones(4).sum()
    assert [e.name for e in prof.events()].count("audiotoken.test") == 1
