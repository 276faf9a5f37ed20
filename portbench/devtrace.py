"""``torch.profiler`` (CUPTI) events of a traced window -> what the per-layer
readers read: device busy time, device time by kernel, copies, and the
idle gaps labelled by what the host was doing.

Device busy time is the union of the device events' spans (side streams
may overlap), kernel time is summed by name. The host's labels are the
benchmark's own ``record_function`` ranges and the host operations inside
them, on the thread that drives the window.
"""

import bisect
import re
from collections import defaultdict

WINDOW = "portbench.window"
CALL = "portbench.call"
_BASE = re.compile(r"[\w:~]+")


def base_name(name: str) -> str:
    """A kernel's name without its return type, template arguments,
    parameters and namespaces: ``void (anonymous namespace)::k<4>(float*)``
    -> ``k``."""
    n = re.sub(r"^void\s+", "", name.strip().replace("(anonymous namespace)::", ""))
    m = _BASE.match(n)
    return m.group(0).split("::")[-1] if m else n


def union_s(spans) -> float:
    """Seconds covered by the union of (start, end) spans in ns."""
    busy, end = 0, None
    for t0, t1 in sorted(spans):
        if end is None or t1 > end:
            busy += t1 - (t0 if end is None else max(t0, end))
            end = t1
    return busy / 1e9


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


class DeviceTrace:
    """The events of one profiled window, in ns of one clock."""

    def __init__(self, events):
        self.device, host, windows = [], [], []
        for e in events:
            name, t0, dur = e.name(), e.start_ns(), e.duration_ns()
            if e.device_type().name == "CUDA":
                user = getattr(e, "is_user_annotation", lambda: False)()
                if not user and not name.startswith("portbench.") and dur > 0:
                    self.device.append((name, t0, t0 + dur))
            else:
                host.append((t0, t0 + dur, name, e.start_thread_id()))
                if name == WINDOW:
                    windows.append((t0, t0 + dur, e.start_thread_id()))
        if not windows:
            raise RuntimeError(f"the trace holds no {WINDOW!r} range")
        self.t0, self.t1, thread = windows[0]
        # by start, the enclosing range before the ranges it holds
        self.host = sorted(((a, b, n) for a, b, n, th in host if th == thread),
                           key=lambda h: (h[0], -h[1]))
        self.device = [(n, max(a, self.t0), min(b, self.t1)) for n, a, b in self.device
                       if b > self.t0 and a < self.t1]
        self.calls = sum(1 for a, b, n in self.host if n == CALL and a >= self.t0 and b <= self.t1)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    @property
    def busy_s(self) -> float:
        return union_s([(a, b) for _, a, b in self.device])

    def kernel_s(self, match=None) -> float:
        """Device seconds of the kernels (not copies) whose base name
        ``match`` accepts (all kernels when None)."""
        return sum(b - a for n, a, b in self.device
                   if not _is_copy(n) and (match is None or match(base_name(n)))) / 1e9

    def copy_s(self) -> float:
        """Device seconds of memory copies and sets."""
        return sum(b - a for n, a, b in self.device if _is_copy(n)) / 1e9

    def device_ops(self, top: int = 10):
        """[[name, seconds]] of the device operations that took most time,
        summed by base name."""
        by = defaultdict(int)
        for n, a, b in self.device:
            by[n if _is_copy(n) else base_name(n)] += b - a
        return [[n, t / 1e9] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10):
        """[[label, seconds]]: the device's idle time inside the window,
        summed by what the host was doing at each gap's middle (the
        innermost host range or operation there, under the benchmark range
        that holds it), the largest first."""
        spans = sorted((a, b) for _, a, b in self.device)
        gaps, end = [], self.t0
        for a, b in spans:
            if a > end:
                gaps.append((end, a))
            end = max(end, b)
        if self.t1 > end:
            gaps.append((end, self.t1))
        starts = [h[0] for h in self.host]
        by = defaultdict(int)
        stack, i = [], 0
        for g0, g1 in sorted(gaps, key=lambda g: g[0] + g[1]):
            mid = (g0 + g1) // 2
            j = bisect.bisect_right(starts, mid)
            for h in self.host[i:j]:
                while stack and stack[-1][1] < h[0]:
                    stack.pop()
                stack.append(h)
            i = j
            while stack and stack[-1][1] < mid:
                stack.pop()
            inner = [h for h in stack if h[1] >= mid]
            outer = next((h[2] for h in reversed(inner) if h[2].startswith("portbench.")), None)
            label = inner[-1][2] if inner else "no host range"
            if outer and outer != label:
                label = f"{outer}/{label}"
            by[label] += g1 - g0
        return [[n, t / 1e9] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:top]]
