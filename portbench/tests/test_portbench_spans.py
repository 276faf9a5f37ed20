"""The split of a traced window's idle time among the program's own spans
(``portbench/spans.py``) and the readers on it, on events made by hand,
and through the whole of a traced run on the CPU."""

import time
from types import SimpleNamespace

import pytest

from portbench import harness, spans
from portbench.devtrace import CALL, WINDOW, DeviceTrace

US = 1000
DEC = "audiotoken.decode"


class _Dev:
    def __init__(self, name):
        self.name = name


class Ev:
    def __init__(self, name, t0, t1, dev="CPU", thread=1):
        self._n, self._t0, self._d, self._dev, self._th = name, t0 * US, (t1 - t0) * US, dev, thread

    def name(self):
        return self._n

    def start_ns(self):
        return self._t0

    def duration_ns(self):
        return self._d

    def device_type(self):
        return _Dev(self._dev)

    def start_thread_id(self):
        return self._th


def _trace(program=True):
    """Two calls of 50 us. The first: prepare 5-20, upload 20-25, forward
    25-40 on the host; on the card a kernel 0-10 and another 30-45. The
    second: steps 55-70 and 70-85 and a readback 85-95; kernels 60-75 and
    90-100."""
    events = [Ev(WINDOW, 0, 100), Ev(CALL, 0, 50), Ev(CALL, 50, 100),
              Ev("k", 0, 10, "CUDA"), Ev("k", 30, 45, "CUDA"), Ev("k", 60, 75, "CUDA"),
              Ev("k", 90, 100, "CUDA"), Ev("aten::copy_", 20, 24)]
    if program:
        events += [Ev(DEC, 2, 48), Ev(f"{DEC}.prepare", 5, 20), Ev(f"{DEC}.upload", 20, 25),
                   Ev(f"{DEC}.forward", 25, 40), Ev(DEC, 52, 97), Ev(f"{DEC}.ar", 53, 96),
                   Ev(f"{DEC}.ar.step", 55, 70), Ev(f"{DEC}.ar.step", 70, 85),
                   Ev(f"{DEC}.ar.readback", 85, 95),
                   Ev(f"{DEC}.ar.step", 0, 100, thread=2)]  # another thread's: not the window's
    return DeviceTrace(events)


def _ctx(trace, path="decode"):
    return SimpleNamespace(trace=trace, path=path)


def test_a_gap_is_split_exactly_among_the_spans_that_cover_it():
    """The gap 10-30 us lies under ``prepare`` (10-20), ``upload`` (20-25)
    and ``forward`` (25-30): each gets its own part, not the whole gap by
    its middle. The gap 45-60 under the first call's span (45-48), no span
    (48-52), the second's (52-53), ``ar`` (53-55) and a step (55-60); the
    gap 75-90 under a step (75-85) and the readback (85-90)."""
    s = spans.program_spans(_trace())
    assert s.idle == pytest.approx({
        None: 4e-6, DEC: 4e-6, f"{DEC}.prepare": 10e-6, f"{DEC}.upload": 5e-6,
        f"{DEC}.forward": 5e-6, f"{DEC}.ar": 2e-6, f"{DEC}.ar.step": 15e-6,
        f"{DEC}.ar.readback": 5e-6})


def test_the_parts_sum_to_the_idle():
    t = _trace()
    s = spans.program_spans(t)
    assert sum(s.idle.values()) == pytest.approx(t.window_s - t.busy_s)
    ctx = _ctx(t)
    host = harness.load_module("metrics", "host_gap_ms.decode", fallback=True).read(ctx)
    launch = harness.load_module("metrics", "launch_gap_ms.decode", fallback=True).read(ctx)
    idle_pct = harness.load_module("metrics", "device_idle_pct.decode", fallback=True).read(ctx)
    outside = 1e3 * s.idle[None] / t.calls
    assert host == pytest.approx(1e3 * (4 + 10 + 5 + 2 + 5) * 1e-6 / 2)
    assert launch == pytest.approx(1e3 * (5 + 15) * 1e-6 / 2)
    assert host + launch + outside == pytest.approx(idle_pct / 100 * 1e3 * t.window_s / t.calls)


def test_a_span_on_the_device_side_reads_nothing():
    """A trace whose device events hold a program span's name (the GPU side
    of a user annotation, on a torch that does not mark it as one) counts
    that range as busy time: nothing is read from it."""
    t = _trace()
    t.device.append((f"{DEC}.ar.step", 55 * US, 70 * US))
    assert spans.program_spans(t) is None
    assert spans.gap_ms(_ctx(t), launch=False) is None


def test_nothing_to_read_without_program_spans():
    t = _trace(program=False)
    assert spans.program_spans(t) is None
    for name in ("host_gap_ms.encode", "host_gap_ms.decode", "launch_gap_ms.decode"):
        reader = harness.load_module("metrics", name, fallback=True)
        assert reader.read(_ctx(t)) is None and reader.read(_ctx(None)) is None


def test_other_entries_spans_are_not_this_entrys():
    assert spans.gap_ms(_ctx(_trace(), "encode"), launch=False) == 0.0


def test_a_traced_run_on_the_cpu_reports_the_split(bench, tiny):
    """A whole traced run of a decode cell: every listed span metric is
    read, and the two gaps lie within the device's idle time a call (on the
    CPU the whole window is idle; the rest is the benchmark's loop)."""
    name = "acoustic.decode.b32x30s"
    r = harness.run_cell(bench, name, 2**31 + 77, 0.3, True, time.perf_counter(), device="cpu",
                         overrides=tiny[name])
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert r["correct"] is True
    assert {"host_gap_ms.decode", "launch_gap_ms.decode"} <= set(m)
    assert m["host_gap_ms.decode"] > 0 and m["launch_gap_ms.decode"] > 0
    idle_ms = m["device_idle_pct.decode"] / 100 * 1e3 * r["device"]["window_s"] / r["attempted"]
    assert m["host_gap_ms.decode"] + m["launch_gap_ms.decode"] <= idle_ms
