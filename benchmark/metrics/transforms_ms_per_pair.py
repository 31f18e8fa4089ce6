"""Layer "transforms and conditioning": device milliseconds a pair of
every kernel but the program's coder and level-scan kernels (kernels
1-5), copies and memsets left out: the transforms, the conditioning's
networks, cuDNN and PyTorch's elementwise kernels."""

CODER_KERNELS = ("gmm_freq_kernel", "grid_rans_encode_kernel",
                 "grid_rans_decode_kernel", "pairs_rans_encode_kernel",
                 "wavefront_")


def read(ctx):
    us = sum(b - a for name, a, b in ctx["trace"]["kernels"]
             if not any(k in name for k in CODER_KERNELS))
    return us / 1e3 / ctx["traced_pairs"]
