"""The yardstick's peaks and the operation and byte counts of the port's
coder kernels, frozen here from the counts the program's kernel smoke
test makes, so that the program can change without moving them.

Peaks: NVIDIA's H100 SXM data sheet at the full 700 W limit.  3.35 TB/s
of HBM3; 67 TFLOP/s of float32 outside the tensor cores, which counts an
FMA as two operations, so un-fused float32 or integer operations run at
33.5e12 a second; 989.4 TFLOP/s of dense bf16 on the tensor cores (the
data sheet's 1,979 is with sparsity).
"""

from __future__ import annotations

PEAK_BYTES = 3.35e12
PEAK_F32_OPS = 33.5e12
PEAK_BF16_FLOPS = 989.4e12

# kernel 1 (gmm_freq): float32 and integer instructions per evaluation,
# counted from the program's deterministic CDF chain: each (component,
# edge) 57, each (component, bin) 3, each bin 8, each component 11
OPS_PER_EDGE, OPS_PER_KBIN, OPS_PER_BIN, OPS_PER_K = 57, 3, 8, 11


def gmm_freq_bound_s(b: int, m: int, k: int, hw: int, mm: int) -> float:
    """The least time of one kernel-1 launch: B pairs, M channels, K
    components, hw latent positions, a grid of S = 2 mm + 1 bins.  The
    larger of its operations at PEAK_F32_OPS and its bytes (the three
    heads read once, the centres, the rows written once) at PEAK_BYTES."""
    s = 2 * mm + 1
    ops = b * m * hw * (k * (s + 1) * OPS_PER_EDGE + k * s * OPS_PER_KBIN
                        + s * OPS_PER_BIN + k * OPS_PER_K)
    nbytes = 4 * (2 * b * k * m * hw + b * k * m + b * m + b * m * s * hw)
    return max(ops / PEAK_F32_OPS, nbytes / PEAK_BYTES)


def grid_rans_bound_s(sym_plus_one: int, n_sym: int, lanes: int) -> float:
    """The least time of one kernel-2 or kernel-3 launch over `n_sym`
    symbols in `lanes` lanes: a symbol's interval needs its frequency
    row's first sym + 1 entries (`sym_plus_one` summed over the
    symbols); each symbol read or written once; each lane's count (i32)
    and state (i64) once.  The coded words are not counted (a few
    percent of the symbols' bytes), so the bound is a little low."""
    return (4 * sym_plus_one + 4 * n_sym + 12 * lanes) / PEAK_BYTES
