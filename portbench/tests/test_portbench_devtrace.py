"""The reduction of a trace's events to busy time, kernel time by name,
copies and labelled idle gaps, on events made by hand."""

import pytest

from portbench.devtrace import CALL, WINDOW, DeviceTrace, base_name, union_s


class _Dev:
    def __init__(self, name):
        self.name = name


class Ev:
    def __init__(self, name, t0, t1, dev="CUDA", thread=1):
        self._n, self._t0, self._d, self._dev, self._th = name, t0, t1 - t0, dev, thread

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


def _trace():
    us = 1000
    return DeviceTrace([
        Ev(WINDOW, 0, 100 * us, "CPU"), Ev(CALL, 0, 50 * us, "CPU"), Ev(CALL, 50 * us, 100 * us, "CPU"),
        Ev("aten::copy_", 0, 10 * us, "CPU"), Ev("aten::conv", 60 * us, 70 * us, "CPU"),
        Ev("other thread", 0, 100 * us, "CPU", thread=2),
        Ev("Memcpy HtoD (Pinned -> Device)", 10 * us, 20 * us),
        Ev("void (anonymous namespace)::lstm_persistent_kernel<4>(float*)", 20 * us, 50 * us),
        Ev("sm80_xmma_gemm_f32", 40 * us, 60 * us),  # overlaps the LSTM: counted once in busy
        Ev(CALL, 0, 50 * us),  # the call's range on the device timeline is not device work
        Ev("void at::native::elementwise_kernel<4>(int)", 75 * us, 90 * us),
        Ev("before the window", -50 * us, -10 * us),
    ])


def test_busy_kernels_copies_and_calls():
    t = _trace()
    assert t.window_s == pytest.approx(100e-6) and t.calls == 2
    assert t.busy_s == pytest.approx(65e-6)  # 10-60 and 75-90 us
    assert t.kernel_s() == pytest.approx(65e-6)
    assert t.kernel_s(lambda n: n == "lstm_persistent_kernel") == pytest.approx(30e-6)
    assert t.copy_s() == pytest.approx(10e-6)
    ops = dict(t.device_ops())
    assert ops["lstm_persistent_kernel"] == pytest.approx(30e-6) and "elementwise_kernel" in ops


def test_idle_gaps_are_labelled_by_the_host():
    gaps = dict(_trace().idle_gaps())
    assert gaps == pytest.approx({f"{CALL}/aten::copy_": 10e-6, f"{CALL}/aten::conv": 15e-6,
                                  CALL: 10e-6})


def test_names_and_union():
    assert base_name("void (anonymous namespace)::k<4, 8>(float const*)") == "k"
    assert base_name("void at::native::vectorized_elementwise_kernel<4>(int)") \
        == "vectorized_elementwise_kernel"
    assert base_name("sm80_xmma_gemm_f32f32_tn") == "sm80_xmma_gemm_f32f32_tn"
    assert union_s([(0, 10), (5, 20), (30, 40)]) == pytest.approx(30e-9)


def test_a_trace_without_the_window_is_refused():
    with pytest.raises(RuntimeError):
        DeviceTrace([Ev("k", 0, 1)])
