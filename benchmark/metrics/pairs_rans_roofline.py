"""Layer "kernel 4" (the slot-stream rANS encode,
codecs/csrc/pairs_rans.cu): kernel 4's share of its roofline, the least
time of the traced launches (their bytes at 3.35 TB/s, as the coder's
``work`` counts them) over the traced pairs_rans_encode_kernel time."""

from benchmark import peaks


def read(ctx):
    us = sum(b - a for name, a, b in ctx["trace"]["kernels"]
             if "pairs_rans_encode_kernel" in name)
    launches = ctx["coder"].get("pairs")
    if not us or not launches:
        return None
    return 100.0 * sum(launches) / peaks.PEAK_BYTES / (us / 1e6)
