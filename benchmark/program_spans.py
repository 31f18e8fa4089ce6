"""The program's own spans and counters in a trace's ``ranges``
(hesic_tpu_torch/utils/tracing.py writes them): spans by name, clipped to
the window, and the values of the counter samples ``count/<name>=<int>``
that fall inside it.  A span whose stage (the part after the first
``/``) is ``wait`` or starts ``wait-`` is the host blocked on the device.
"""

from __future__ import annotations

from benchmark import profiling


def spans(trace, keep) -> list:
    """(start_us, end_us) of the ranges whose name `keep` accepts, clipped
    to the window."""
    return profiling.clip([(a, b) for name, a, b in trace["ranges"]
                           if keep(name)], trace["window"])


def counts(trace, name: str) -> list:
    """The values of the ``count/<name>`` samples inside the window."""
    lo, hi = trace["window"]
    head = f"count/{name}="
    return [int(n[len(head):]) for n, a, _ in trace["ranges"]
            if n.startswith(head) and lo <= a <= hi]


def is_wait(name: str) -> bool:
    stage = name.partition("/")[2]
    return stage == "wait" or stage.startswith("wait-")
