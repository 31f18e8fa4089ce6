"""Running-average meters, wall-clock spans and a device trace.

Counterpart of hesic_tpu/utils/logging.py.  ``AverageMeter`` keeps the
last value (``val``) apart from the mean (``avg``): the reference's
published errata came from logging one for the other.  ``SpanTimer``
times named spans; a span given ``sync`` (a tensor or a device)
synchronises that CUDA device before it reads the clock, so it times the
work and not only its launch.  ``device_trace`` records a
``torch.profiler`` trace of a block (the card's kernels as well where
CUDA is available) into ``logdir``.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


class AverageMeter:
    """Running average.  ``val`` is the LAST value; ``avg`` the mean."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        val = float(val)
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count


def _synchronize(sync) -> None:
    device = sync.device if torch.is_tensor(sync) else torch.device(sync)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class SpanTimer:
    """Named wall-clock spans with running averages.

    >>> spans = SpanTimer()
    >>> with spans("encode", sync=x): ...
    >>> spans.report()
    """

    def __init__(self):
        self.meters = defaultdict(AverageMeter)

    @contextlib.contextmanager
    def __call__(self, name: str, sync=None):
        if sync is not None:
            _synchronize(sync)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                _synchronize(sync)
            self.meters[name].update(time.perf_counter() - t0)

    def report(self) -> str:
        return " | ".join(
            f"{k}: {m.avg * 1000:.1f}ms (n={m.count})"
            for k, m in self.meters.items())


@contextlib.contextmanager
def device_trace(logdir: str):
    """Record a torch.profiler trace of the block into
    ``logdir/trace.json`` (Chrome trace format)."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
