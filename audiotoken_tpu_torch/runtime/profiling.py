"""Stage timers and trace capture.

Counterpart of ``audiotoken_tpu/runtime/profiling.py``: named wall-clock
spans that accumulate per stage (the corpus executor feeds them), and a
``torch.profiler`` trace around any block.

On a CUDA device a span with ``sync=True``, and ``timed``, wait for the
device with ``torch.cuda.synchronize`` so that the span covers the device
work queued inside it. On the CPU there is nothing to wait for: the spans
are host spans, and :meth:`StageTimers.summary` says so in ``clock``.
"""

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import torch

from ..logger import get_logger

logger = get_logger(__name__)


class StageTimers:
    """Accumulating named wall-clock spans.

    ``device`` is where the timed work runs; a CUDA device makes ``sync``
    spans and ``timed`` wait for it."""

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

    def timed(self, name: str, value):
        """Wait for the device work behind ``value`` and account the wait
        under ``name``; returns ``value``."""
        with self.span(name, sync=True):
            return value

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
    ``logdir`` is None or empty."""
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
