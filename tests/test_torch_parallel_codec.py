"""Port: the batch-split codecs of hesic_tpu_torch.parallel on gloo process
groups on the CPU, mirroring tests/test_training_parallel.py's
TestShardedCodec: ``sharded_codec_roundtrip`` for 'hesic', 'dsic' and
'hesic-plus' (the wavefront device codec) at the JAX function's tiny
widths, 4 pairs a rank, at world 2 (8 pairs, as JAX's 8-device mesh
codes) and world 1.  The function itself asserts, on every rank, that
the decoded latents equal the encoder's and that the container bytes
and decoded latents equal the one-process run's; the tests check what
it returns and that every rank returns the same.  A batch whose halves
pick different grid widths and warp windows alone checks that the split
encode agrees them over the ranks (world 2).

The ranks are subprocesses (tests/torch_parallel_ranks.py: a ``file://``
store under tmp_path, a 60 s group timeout, a 240 s process timeout).
About 20 s on the CPU.
"""

import numpy as np
import pytest

from torch_parallel_ranks import launch

ARCHS = ("hesic", "dsic", "hesic-plus")


@pytest.fixture(scope="module", params=[1, 2], ids=["world1", "world2"])
def ranks(request, tmp_path_factory):
    world = request.param
    return world, launch(tmp_path_factory.mktemp(f"codec{world}"), world,
                         "codec")


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    return launch(tmp_path_factory.mktemp("mixed"), 2, "mixed")


def test_split_encode_agrees_the_batch_choices(mixed):
    """Alone, the two ranks' pairs pick different grids and warp windows
    (torch_parallel_ranks.mixed_inputs); split, every rank writes the one
    process's batch container and per-pair containers byte for byte, and
    the split decode gives the one process's outputs bit for bit."""
    head0, head1 = (bytes(r["alone_head"]) for r in mixed)
    assert head0[1:4] != head1[1:4], (head0, head1)
    for r in mixed:
        np.testing.assert_array_equal(r["split"], r["one"])
        np.testing.assert_array_equal(r["pairs_split"], r["pairs_one"])
        for k in ("x1_hat", "x2_hat", "y1_hat", "y2_hat"):
            np.testing.assert_array_equal(r["rec:" + k], r["ref:" + k])


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_codec_roundtrip_matches_one_process(ranks, arch):
    world, results = ranks
    for r in results:
        assert int(r[f"{arch}:pairs"]) == 4 * world
        assert int(r[f"{arch}:blob_bytes"]) > 0
        assert 0 < float(r[f"{arch}:bpp_real"]) < 24
    # every rank returns the one batch container
    assert len({int(r[f"{arch}:blob_bytes"]) for r in results}) == 1


def test_hoist_plan_takes_the_dry_run_widths():
    """Kernel 5's hoisted product takes a k-step of at most its one chunk
    of k = P + Q rows, in multiples of 16 (csrc/wavefront.cu plan_ok).
    The dry run's HESIC+ N=8/M=16 has k 32 (eye 1) and 48 (eye 2), below
    the full width's k-step of 192, which the plan had passed as is, so
    the kernel refused the split codec's tiny widths on the card."""
    from hesic_tpu_torch.models import HESICPlus, HESICPlusDeviceCodec
    from hesic_tpu_torch.models.wavefront import (HOIST_PLAN, TILE_WIDTHS,
                                                  hoist_plan)
    for n, m in ((8, 16), (192, 192)):
        codec = HESICPlusDeviceCodec(HESICPlus(N=n, M=m, device="cpu"),
                                     mm=8, groups=4)
        for w in (codec.w1, codec.w2):
            k = w.w0_pp.shape[0]
            bn, kt = hoist_plan(k)
            assert bn in TILE_WIDTHS and kt % 16 == 0 and 0 < kt <= k, k
            if k >= HOIST_PLAN.kt:      # the full width's plan unchanged
                assert (bn, kt) == (HOIST_PLAN.bn, HOIST_PLAN.kt)
