"""Port: HESIC's entropy estimate against its real coder, in both
packages (ROADMAP C, "To check").

On the card, eval_model read HESIC's estimate (2.3762 bpp) above its real
coder's (2.3575) at 4-step weights.  Here both packages' eval_model run
the real coder and --entropy-estimation on one stereo folder (two random
64x64 pairs) with one JAX codec file (HESIC N16/M24/K2 at its random
init), as tests/test_torch_eval_model.py sets up its estimate case.  The
JAX package reads the same order (its estimate 1.10988 bpp, its real
coder 0.88525), so the order is the model's, not the port's; the port's
real coder reads within 1% of the JAX package's bpp (0.88525390625 in
both, measured) and its estimate within 1e-4 of JAX's.  About 35 s on
the CPU, most of it the JAX package's jit compiles.
"""

import torch

from hesic_tpu_torch.utils import eval_model
from test_torch_eval_model import _stereo_tree

torch.set_num_threads(2)


def test_estimate_reads_above_the_real_coder_in_both_packages(tmp_path):
    import hesic_tpu.zoo as jzoo
    from hesic_tpu.utils import eval_model as j_eval
    data = _stereo_tree(tmp_path / "d", n=2, size=64)
    ckpt = str(tmp_path / "jax.pkl")
    jzoo.create_model("hesic", image_size=(64, 64), N=16, M=24,
                      K=2).save(ckpt)
    args = ["--arch", "hesic", "--dataset", data, "--checkpoint", ckpt]
    bpp = {}
    for mode, extra in (("real", []), ("estimate", ["--entropy-estimation"])):
        bpp["jax", mode] = j_eval.main(args + extra)["results"]["bpp"]
        bpp["port", mode] = eval_model.main(
            args + extra + ["--device", "cpu"])["results"]["bpp"]
    for pkg in ("jax", "port"):
        assert bpp[pkg, "estimate"] > bpp[pkg, "real"], (pkg, bpp)
    assert abs(bpp["port", "real"] / bpp["jax", "real"] - 1) < 1e-2
    assert abs(bpp["port", "estimate"] / bpp["jax", "estimate"] - 1) < 1e-4
