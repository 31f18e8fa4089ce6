"""Spans and counters on torch.profiler's timeline.

``span(name)`` is a ``torch.profiler.record_function`` range while a
profiler records, and one shared no-op context otherwise, so a span
costs a flag test when nothing traces.  ``count(name, value)`` leaves a
zero-length range named ``count/<name>=<value>`` where it is called: a
counter sample on the trace's own clock, scoped to the traced stretch,
with no state of its own.  ``call(name, batch, device)`` is the span of a
public codec call: it holds ``count/batch=<batch>`` and, at its end,
``count/device_allocs``, the allocator calls made inside it
(``allocator_calls``).

None of them synchronises, reads a device tensor or allocates on the
device: a counter's value is already on the host, and the allocators'
statistics are host counters, read only while a profiler records.

The names the codecs use (``codec/``, ``enc/``, ``dec/``, ``dsic/``,
``count/``; a stage named ``wait`` or ``wait-...`` is the host blocked on
the device) are listed in the README's section on tracing.
"""

from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()


def recording() -> bool:
    """Whether a profiler is recording in this process."""
    return torch.autograd.profiler._is_profiler_enabled


def span(name: str):
    """A profiler range named `name`, or the no-op context."""
    if not recording():
        return _OFF
    return torch.profiler.record_function(name)


def count(name: str, value) -> None:
    """A counter sample ``count/<name>=<int(value)>``; nothing when no
    profiler records.  `value` must be a host number."""
    if recording():
        with torch.profiler.record_function(f"count/{name}={int(value)}"):
            pass


def allocator_calls(device):
    """The calls the allocators of `device` have made so far: the caching
    allocator's cudaMalloc and cudaFree (``num_device_alloc`` +
    ``num_device_free`` of ``torch.cuda.memory_stats``) plus the pinned
    host allocator's new blocks (``num_host_alloc`` of
    ``torch.cuda.host_memory_stats``), read from the unflattened forms of
    both.  None off the card."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    dev = torch.cuda.memory_stats_as_nested_dict(device)
    host = torch.cuda.host_memory_stats_as_nested_dict()
    return (dev["num_device_alloc"] + dev["num_device_free"]
            + host["num_host_alloc"])


@contextlib.contextmanager
def _call(name: str, batch: int, device):
    before = allocator_calls(device)
    with torch.profiler.record_function(name):
        count("batch", batch)
        yield
        if before is not None:
            count("device_allocs", allocator_calls(device) - before)


def call(name: str, batch: int, device):
    """The span of a public call on `device`: ``span(name)`` holding
    ``count/batch=<batch>`` and, when the call returns, on the card,
    ``count/device_allocs``; the no-op context when nothing records."""
    if not recording():
        return _OFF
    return _call(name, batch, device)
