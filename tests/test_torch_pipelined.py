"""Port: the fast codecs' shared pipelined protocol
(hesic_tpu_torch/models/base.py ``PipelinedCodec``), as HESIC's and DSIC's
``HESICFastCodec`` and HESIC+'s ``HESICPlusDeviceCodec`` run it, on the
CPU at tiny widths with random weights (HESIC N16/M24/K2, DSIC
N16/M24/F6/C4/K2 at grid caps mm 4 and 1; HESIC+ N16/M24, 4 channel
groups, mm 1), batches of 2 pairs of 64x64 images whose latents pass the
grid, so that both eyes of every decode have escapes to correct.

* The dispatch paths (``compress_fast_start`` after a first encode has
  picked the grids, ``decompress_fast_batch``) call nothing that reads a
  tensor back to the host or stores into one by index, outside each
  codec's kernels, whose plain twins stand in for the card's kernels
  here; the started encode still finishes to the synchronous container.
"""

import numpy as np
import pytest
import torch

from hesic_tpu_torch.codecs import grid_rans, pairs_rans, pmf
from hesic_tpu_torch.models import dsic, wavefront
from hesic_tpu_torch.models.ar_device import HESICPlusDeviceCodec
from hesic_tpu_torch.models.dsic import DSIC
from hesic_tpu_torch.models.dsic_fast import DSICFastCodec
from hesic_tpu_torch.models.hesic import HESIC
from hesic_tpu_torch.models.hesic_fast import HESICFastCodec
from hesic_tpu_torch.models.hesic_plus import HESICPlus

torch.set_num_threads(2)

B, M, SIZE = 2, 24, 64
# each codec's kernels, by the plain twins the CPU runs
GRID_TWINS = ((pmf, "gmm_freq_plain"), (grid_rans, "rans_encode_grid_plain"),
              (grid_rans, "rans_decode_grid_plain"))
TWINS = {"hesic": GRID_TWINS,
         "dsic": GRID_TWINS + ((dsic, "dense_warp_plain"),),
         "hesic-plus": ((pairs_rans, "rans_encode_pairs_plain"),
                        (wavefront, "ar_wavefront_plain"))}
ARCHS = tuple(TWINS)


def _codec(arch):
    if arch == "hesic":
        return HESICFastCodec(HESIC(N=16, M=M, K=2, device="cpu", seed=0),
                              mm=4, codec_batch=B).update()
    if arch == "dsic":
        return DSICFastCodec(DSIC(N=16, M=M, F=6, C=4, K=2, device="cpu",
                                  seed=0), mm=1, codec_batch=B).update()
    return HESICPlusDeviceCodec(HESICPlus(N=16, M=M, device="cpu", seed=0),
                                mm=1, groups=4).update()


def _inputs(arch):
    rng = np.random.RandomState(5)
    x1, x2 = ((rng.rand(B, SIZE, SIZE, 3) * 4 - 1.5).astype(np.float32)
              for _ in range(2))
    th = 0.1
    h = np.array([[np.cos(th), -np.sin(th), 5.0],
                  [np.sin(th), np.cos(th), -1.0], [0, 0, 1]], np.float32)
    return x1, x2, None if arch == "dsic" else np.tile(h[None], (B, 1, 1))


@pytest.mark.parametrize("arch", ARCHS)
def test_dispatch_paths_read_nothing_back(arch, monkeypatch):
    """Outside the codec's kernels, the dispatch paths call nothing that
    reads a tensor back to the host or stores into one by index,
    escapes included."""
    codec = _codec(arch)
    x1, x2, h = _inputs(arch)
    out = codec.compress_fast(x1, x2, h, batch_container=True)
    escapes = out["outliers"] if "outliers" in out else out["escapes"]
    assert min(escapes) > 0
    blob = out["blob"]
    in_twin = []

    def refusing(name, owner=torch.Tensor):
        real = getattr(owner, name)

        def refuse(*a, **k):
            if not in_twin:
                raise AssertionError(f"a dispatch path called {name}")
            return real(*a, **k)
        return refuse

    def kernel(real):
        def run(*a, **k):
            in_twin.append(1)
            try:
                return real(*a, **k)
            finally:
                in_twin.pop()
        return run

    for mod, name in TWINS[arch]:
        monkeypatch.setattr(mod, name, kernel(getattr(mod, name)))
    # an indexed store copies a Python number up from pageable memory
    for name in ("cpu", "item", "tolist", "numpy", "nonzero", "__bool__",
                 "__int__", "__index__", "__setitem__"):
        monkeypatch.setattr(torch.Tensor, name, refusing(name))
    monkeypatch.setattr(torch, "nonzero", refusing("nonzero", torch))
    monkeypatch.setattr(torch.cuda, "synchronize",
                        refusing("synchronize", torch.cuda))
    handle = codec.compress_fast_start(x1, x2, h)
    codec.decompress_fast_batch(blob)
    monkeypatch.undo()
    assert handle["mode"] == "async"
    assert codec.compress_fast_finish(handle)["blob"] == blob
