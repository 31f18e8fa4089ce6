"""Coders: what the benchmark knows of a codec's container and entropy
coder, one module a coder, ``benchmark/coders/<name>.py``.

A configuration names its coder with ``"coder": "<name>"``; without the
key it is ``grid`` (HESIC's and DSIC's fast codecs and their batch
container).  ``run.coder`` loads the module by its path before the
program's set-up, and a name with no file fails there.  The check
(``judge.py``), the run (``run.py``) and the control (``limits.py``) call
these functions of it and know nothing else of the container:

1. ``build(cls, model, cfg, traffic)``: the codec of the configuration's
   ``program.codec`` class `cls` over the program's `model`, readied for
   the traffic (its ``update()`` called).
2. ``encoded(codec, batch, blob)``: what the program's encoder coded for
   a kept decode, whose pool batch (``{"x1", "x2": NHWC, "h"}``) is
   `batch` and whose container is `blob`: ``(y1, y2, z1, z2)``, NCHW
   float, the coded latents of each eye and the hyper-latent symbols.
3. ``quantise(ref, model, eye, y, context)``: the reference's latents `y`
   (NCHW float) of `eye` (0 left, 1 right) quantised as this coder
   quantises them; `context` is the decoded latents of that eye (NCHW)
   where the quantisation reads a causal context from them, which the
   reference module `ref` supplies, and None in the control, where the
   coder reads its own.
4. ``stated(blob, cfg)``: what the container states of its own rate:
   ``{"bits": (B, 2, lanes) float64, "params": ...}``, the code length of
   each pair's each eye in each lane, and the coding parameters it
   states (grid half-widths, or whatever the coder needs to rebuild its
   rows).
5. ``reference_bits(ref, model, batch, d)``: the code length (B, 2,
   lanes) that the container's coder gives the decoded latents
   ``d["y1"], d["y2"]`` under rows built from the reference's
   conditioning of the encoder's symbols ``d["z1"], d["z2"]`` (and
   whatever else the coder's rows read), at ``d["params"]``: the row
   model and the lane order live here.
6. ``control_stated(ref, model, batch, y1, y2, z1, z2, cfg, traffic)``:
   the fp8 control's outputs (its quantised latents and its symbols) in
   the form of 4: the parameters the container would state for them,
   and their code length under rows from the control's own
   conditioning.
7. ``work(ref, model, pool, programs, cfg)``: the coder's work in a
   traced stretch, from its ``programs`` (kind, pool index, coding
   parameters) as the loop records them, in the form the roofline
   metrics read as ``ctx["coder"]``.
"""
