"""Layer "kernels 2-3": kernels 2 and 3's share of their roofline, the
least time of the traced encode and decode launches (bytes at the
reference's symbols on the containers' grids) over the traced grid_rans
kernels' time."""

from benchmark import peaks


def read(ctx):
    us = sum(b - a for name, a, b in ctx["trace"]["kernels"]
             if "grid_rans_encode_kernel" in name
             or "grid_rans_decode_kernel" in name)
    launches = ctx["coder"]["rans"]
    if not us or not launches:
        return None
    bound = sum(peaks.grid_rans_bound_s(*r) for r in launches)
    return 100.0 * bound / (us / 1e6)
