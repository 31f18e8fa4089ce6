"""Layer "codec host half" (models/hesic_fast.py, models/base.py): the
host's busy milliseconds a pair, the union of the program's ``codec/...``
spans less the time inside its wait spans (``*/wait``, ``*/wait-...``:
the host blocked on the device), over the traced pairs."""

from benchmark import profiling, program_spans


def read(ctx):
    tr = ctx["trace"]
    calls = program_spans.spans(tr, lambda n: n.startswith("codec/"))
    if not calls:
        return None
    waits = program_spans.spans(tr, program_spans.is_wait)
    busy = profiling.union_us(calls + waits) - profiling.union_us(waits)
    return busy / 1e3 / ctx["traced_pairs"]
