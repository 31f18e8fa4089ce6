"""Layer "host z coder" (codecs/host_rans.py): milliseconds a pair in the
host's coding of the z strings, the union of the program's ``enc/z-rans``
and ``dec/z-rans`` spans, over the traced pairs; nothing unless the
stretch holds both."""

from benchmark import profiling, program_spans


def read(ctx):
    enc, dec = (program_spans.spans(ctx["trace"], lambda n, s=s: n == s)
                for s in ("enc/z-rans", "dec/z-rans"))
    if not enc or not dec:
        return None
    return profiling.union_us(enc + dec) / 1e3 / ctx["traced_pairs"]
