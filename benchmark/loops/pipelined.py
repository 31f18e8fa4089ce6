"""Closed loop over batch containers, mode 2 pipelining: each iteration
dispatches the decode of batch i-1, starts the encode of batch i+1 and
finishes batch i (``compress_fast_start`` / ``compress_fast_finish`` /
``decompress_fast_batch``).  The pool's batches are cycled.

The window starts the first encode at t0 and stops starting new ones once
``seconds`` have passed; the batches in flight are then finished,
decoded and the device synchronised, and the window ends there, so every
pair counted was encoded and decoded inside it.
"""

from __future__ import annotations

import time

from benchmark import profiling


def warm_up(codec, pool, sync) -> None:
    """Every pool batch through the synchronous batch encode and the batch
    decode, then one pipelined pass over the pool: every shape and grid
    the window uses."""
    for b in pool:
        out = codec.compress_fast(b["x1"], b["x2"], b["h"],
                                  batch_container=True)
        codec.decompress_fast_batch(out["blob"])
    for b in pool:
        codec.compress_fast_finish(
            codec.compress_fast_start(b["x1"], b["x2"], b["h"]))
    sync()


def window(codec, pool, seconds: float, keep: set, trace_iters: int,
           sync) -> dict:
    """Run the window.  `keep`: iteration indices whose decode outputs are
    kept for the check, each as (pool index, the decode's outputs, the
    container); `trace_iters` > 0 traces that many iterations from the
    first one that starts after half the window."""
    n = len(pool)
    bsz = pool[0]["x1"].shape[0]
    kept, programs, bits = [], [], 0
    trace, traced_pairs = None, 0

    def start(i):
        b = pool[i % n]
        return codec.compress_fast_start(b["x1"], b["x2"], b["h"])

    def one(i, handle, prev, last):
        """Iteration i -> (next handle, the finished container of i)."""
        if prev is not None:
            rec = codec.decompress_fast_batch(prev)
            programs.append(("dec", (i - 1) % n, tuple(prev[1:3])))
            if i - 1 in keep:
                kept.append(((i - 1) % n, rec, prev))
        nxt = None if last else start(i + 1)
        if nxt is not None and nxt.get("mm") is not None:
            programs.append(("enc", (i + 1) % n, tuple(nxt["mm"])))
        return nxt, codec.compress_fast_finish(handle)["blob"]

    sync()
    t0 = time.perf_counter()
    t_end = t0 + seconds
    handle, prev, i = start(0), None, 0
    while True:
        now = time.perf_counter()
        if trace_iters and trace is None and now >= t0 + seconds / 2:
            del programs[:]
            with profiling.traced(sync) as tr:
                for _ in range(trace_iters):
                    handle, blob = one(i, handle, prev, False)
                    bits += 8 * len(blob)
                    prev, i = blob, i + 1
            trace, traced_pairs = tr["trace"], trace_iters * bsz
            traced_programs = list(programs)
            continue
        last = now >= t_end
        handle, blob = one(i, handle, prev, last)
        bits += 8 * len(blob)
        prev, i = blob, i + 1
        if last:
            break
    rec = codec.decompress_fast_batch(prev)
    if i - 1 in keep:
        kept.append(((i - 1) % n, rec, prev))
    sync()
    elapsed = time.perf_counter() - t0
    pairs = i * bsz
    out = {"pairs": pairs, "seconds": elapsed, "bits": bits, "kept": kept,
           "metrics": {"pairs_per_s": pairs / elapsed}}
    if trace is not None:
        out.update(trace=trace, traced_pairs=traced_pairs,
                   programs=traced_programs)
    return out
