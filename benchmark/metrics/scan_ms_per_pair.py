"""Layer "kernel 5": the device milliseconds a pair of the level scan's
kernels (every kernel whose name holds ``wavefront_``: the hoisted
product, the context and layer stages and the coder), over the traced
pairs."""


def read(ctx):
    us = sum(b - a for name, a, b in ctx["trace"]["kernels"]
             if "wavefront_" in name)
    if not us:
        return None
    return us / 1e3 / ctx["traced_pairs"]
