"""Layer "device memory allocators": the allocator calls a batch, the sum
of the program's ``count/device_allocs`` samples in the window (each
codec call's cudaMalloc and cudaFree calls and new pinned host blocks)
over the ``codec/compress_fast_finish`` spans in it."""

from benchmark import program_spans


def read(ctx):
    tr = ctx["trace"]
    calls = program_spans.counts(tr, "device_allocs")
    batches = program_spans.spans(
        tr, lambda n: n == "codec/compress_fast_finish")
    if not calls or not batches:
        return None
    return sum(calls) / len(batches)
