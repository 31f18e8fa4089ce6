"""What a batch container says of its own rate: each pair's code length of
each eye's latents in each lane, read from the bytes the program wrote.

A frozen copy of the batch container's public layout (the program's
``compress_fast(batch_container=True)``): byte 0 the writer, bytes 1-4
the grid half-widths mm1 and mm2, the warp window and the x window; u32
height, width, pairs b and lanes per pair; per pair the two z strings
(u32 length, bytes); per pair the two eyes' outlier records (u32 n, n
u32 indices, n i32 values); per pair the two eyes' constant-channel
bitmaps (ceil(M / 8) bytes each); the centres (i8, 2 b M); the
homographies (f32, 9 b); then per eye the lanes' word counts (u8 mode 1:
u16 base and u8 deltas; mode 0: u16 each), their final states (u32) and
the 16-bit words.

The y coder is rANS with 16-bit words and probabilities, every lane's
state starting at 2^16.  A lane's code length is therefore 16 bits a
word plus log2(final state) - 16: the sum over its symbols of
-log2(frequency / 2^16), up to the coder's rounding, whatever the
frequencies were.
"""

from __future__ import annotations

import numpy as np

STATE_START_BITS = 16


def _counts(blob: bytes, off: int, n: int):
    mode = blob[off]
    off += 1
    if mode == 1:
        base = int(np.frombuffer(blob, np.uint16, 1, off)[0])
        off += 2
        return base + np.frombuffer(blob, np.uint8, n, off).astype(
            np.int64), off + n
    return np.frombuffer(blob, np.uint16, n, off).astype(np.int64), \
        off + 2 * n


def y_code_bits(blob: bytes, m: int) -> dict:
    """{"mm": (mm1, mm2), "win", "bits": (b, 2, lanes) float64}: each
    pair's code length of each eye's y in each lane, in bits.  Raises if
    the layout does not end at the container's last byte."""
    mm, win = (blob[1], blob[2]), blob[3]
    _, _, b, lanes = (int(v) for v in np.frombuffer(blob, np.uint32, 4, 5))
    off = 21
    for _ in range(2 * b):                          # z strings
        off += 4 + int(np.frombuffer(blob, np.uint32, 1, off)[0])
    for _ in range(2 * b):                          # outlier records
        off += 4 + 8 * int(np.frombuffer(blob, np.uint32, 1, off)[0])
    off += 2 * b * (-(-m // 8)) + 2 * b * m + 36 * b
    bits = np.zeros((b, 2, lanes))
    for eye in range(2):
        c, off = _counts(blob, off, b * lanes)
        st = np.frombuffer(blob, np.uint32, b * lanes, off).astype(
            np.float64)
        off += 4 * b * lanes + 2 * int(c.sum())
        bits[:, eye] = (16 * c + np.log2(st) - STATE_START_BITS).reshape(
            b, lanes)
    if off != len(blob):
        raise ValueError(f"batch container: the layout ends at byte {off} "
                         f"of {len(blob)}")
    return {"mm": mm, "win": win, "bits": bits}
