"""Layer "kernels 2-3" (the grid coder's useful work): latents that left
the grid as escapes, per million latents coded, from the program's
``count/escapes`` and ``count/latents`` samples in the window."""

from benchmark import program_spans


def read(ctx):
    tr = ctx["trace"]
    latents = sum(program_spans.counts(tr, "latents"))
    if not latents:
        return None
    return 1e6 * sum(program_spans.counts(tr, "escapes")) / latents
