"""Layer "transfers" (the program's ``_upload``, ``_fetch`` and
``_fetch_words``): KiB a pair that cross between host and device, the sum
of the program's ``count/h2d_bytes`` and ``count/d2h_bytes`` samples in
the window, over the traced pairs."""

from benchmark import program_spans


def read(ctx):
    tr = ctx["trace"]
    n = (program_spans.counts(tr, "h2d_bytes")
         + program_spans.counts(tr, "d2h_bytes"))
    if not n:
        return None
    return sum(n) / 1024 / ctx["traced_pairs"]
