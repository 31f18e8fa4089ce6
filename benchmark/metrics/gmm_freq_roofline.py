"""Layer "kernel 1": kernel 1's share of its roofline, the least time of
the traced launches (the frozen operation and byte count at each
launch's batch, widths, latent size and grid) over the traced
gmm_freq_kernel time."""

from benchmark import peaks


def read(ctx):
    us = sum(b - a for name, a, b in ctx["trace"]["kernels"]
             if "gmm_freq_kernel" in name)
    launches = ctx["coder"]["gmm"]
    if not us or not launches:
        return None
    bound = sum(peaks.gmm_freq_bound_s(*g) for g in launches)
    return 100.0 * bound / (us / 1e6)
