"""Stage timers, trace spans and trace capture.

Counterpart of ``audiotoken_tpu/runtime/profiling.py``: named wall-clock
spans that accumulate per stage (the corpus executor feeds them), and a
``torch.profiler`` trace around any block.

On a CUDA device a :class:`StageTimers` span with ``sync=True`` waits for
the device with ``torch.cuda.synchronize`` so that the span covers the
device work queued inside it. On the CPU there is nothing to wait for: the
spans are host spans, and :meth:`StageTimers.summary` says so in ``clock``.

:func:`span` marks a step of the encoders and decoders (``audiotoken.*``)
in a ``torch.profiler`` trace, on the profiler's clock beside the kernels
and copies; while no profiler records it only reads the profiler's flag.
"""

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import torch

from torch.autograd import profiler as _autograd_profiler

from ..logger import get_logger

logger = get_logger(__name__)

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``torch.profiler.record_function(name)`` range while a profiler
    records (on any thread), else a shared no-op context: no range is made
    and nothing is waited for."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


class StageTimers:
    """Accumulating named wall-clock spans.

    ``device`` is where the timed work runs; a CUDA device makes ``sync``
    spans wait for it."""

    def __init__(self, device="cpu"):
        self.device = torch.device(device)
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @property
    def clock(self) -> str:
        """``"device"`` when synchronised spans cover device work, else ``"host"``."""
        return "device" if self.device.type == "cuda" else "host"

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def span(self, name: str, sync: bool = False):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync:
                # drain the device queue so that the span covers its work
                self._sync()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, dict]:
        return {
            k: {"total_s": round(v, 4), "count": self.counts[k],
                "mean_ms": round(1000 * v / max(self.counts[k], 1), 3), "clock": self.clock}
            for k, v in sorted(self.totals.items())
        }

    def log(self):
        for k, v in self.summary().items():
            logger.info("stage %-24s %s", k, v)


@contextlib.contextmanager
def profile_trace(logdir: Optional[str] = None):
    """Trace the block with ``torch.profiler`` (host and CUDA activity) and
    write a Chrome trace, ``trace.json``, into ``logdir``; a no-op when
    ``logdir`` is None or empty. The trace holds the encoders' and
    decoders' ``audiotoken.*`` spans (:func:`span`) beside the kernels."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        path = os.path.join(logdir, "trace.json")
        prof.export_chrome_trace(path)
        logger.info("profiler trace written to %s", path)
