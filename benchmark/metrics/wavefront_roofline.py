"""Layer "kernel 5" (the level scan, codecs/csrc/wavefront.cu): kernel 5's
share of its roofline, the least time of the traced passes (their GEMM
FLOPs at 67 TFLOP/s of float32 plus their coder's operations at
33.5e12/s, as the coder's ``work`` counts them) over the traced time of
the wavefront kernels, the hoisted product's included."""

from benchmark import peaks


def read(ctx):
    us = sum(b - a for name, a, b in ctx["trace"]["kernels"]
             if "wavefront_" in name)
    passes = ctx["coder"].get("wavefront")
    if not us or not passes:
        return None
    bound = sum(f / (2 * peaks.PEAK_F32_OPS) + ops / peaks.PEAK_F32_OPS
                for f, ops in passes)
    return 100.0 * bound / (us / 1e6)
