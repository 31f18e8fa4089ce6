"""Batch-split codecs over a mesh's "data" axis, as
hesic_tpu/parallel/codec.py.

The JAX package runs the fast codec's device programs SPMD with every
batch-led tensor sharded over "data", and holds the result to the
one-device run.  Here each rank codes its contiguous slice of the batch,
and the ranks agree, by hand, on what the encode picks from the whole
batch:

  * HESIC and DSIC (``split_compress_fast``): the warp windows (win,
    xwin) come from every pair's homography (all-gathered), and each
    eye's grid width from the batch's largest spread (all-reduced with
    MAX), before the device half codes the rank's pairs.  The batch
    container is then assembled on every rank from the ranks' host
    pieces (all_gather_object, in rank order), so its bytes are the one
    process's.  The conditioning programs run at the codec's canonical
    batch (``codec_batch``) on every rank, so a slice gets the rows the
    whole batch gets.  ``split_decompress_fast_batch``: each rank decodes
    its own pairs of the container, and the outputs are all-gathered.
  * HESIC+ (``split_compress_wavefront``): the level scan folds the batch
    into rANS lanes and the container is one blob for the batch, so each
    rank runs the transforms on its slice, the latents, z symbols and
    homographies are all-gathered, and every rank runs the chain and the
    level scans over the whole batch: what GSPMD does with the JAX
    program (partition the transforms, gather where the lane fold
    crosses the split).  Every rank decodes the whole blob.

At a world of one every collective is the identity, so the split code
must give the one-process code's bytes bit for bit.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from ..geometry import pick_warp_win, pick_warp_xwin
from ..models.hesic_fast import _check_format
from .mesh import DATA_AXIS, _gather_batch, _sizes, mesh_device

_OUTPUTS = ("x1_hat", "x2_hat", "y1_hat", "y2_hat")


def _data(mesh):
    """(dp, this rank's "data" coordinate, the "data" group)."""
    return (_sizes(mesh)[0], mesh.get_local_rank(DATA_AXIS),
            mesh.get_group(DATA_AXIS))


def _gather_objects(obj, group, dp: int) -> list:
    out = [None] * dp
    dist.all_gather_object(out, obj, group=group)
    return out


def _merge_pieces(parts: list) -> dict:
    """The ranks' host pieces (HESICFastCodec._host_pieces), in rank
    order -> the whole batch's, pair after pair."""
    def cat(key, eye, i=None):
        return np.concatenate([p[key][eye] if i is None else p[key][eye][i]
                               for p in parts])

    return {
        "z": (cat("z", 0), cat("z", 1)),
        "outliers": tuple([o for p in parts for o in p["outliers"][e]]
                          for e in range(2)),
        "dead": (cat("dead", 0), cat("dead", 1)),
        "centres": (cat("centres", 0), cat("centres", 1)),
        "streams": tuple(tuple(cat("streams", e, i) for i in range(3))
                         for e in range(2)),
    }


@torch.no_grad()
def split_compress_fast(codec, mesh, x1, x2, h_matrix=None,
                        batch_container: bool = True) -> dict:
    """HESICFastCodec.compress_fast (or DSICFastCodec's) of the batch
    whose slice at this rank's "data" coordinate is x1, x2 (b, H, W, 3)
    and h_matrix (b, 3, 3), every rank calling with its own slice.  Every
    rank returns the whole batch's containers, byte for byte the one
    process's."""
    dp, _, group = _data(mesh)
    t0 = time.perf_counter()
    b, h_img, w_img = x1.shape[:3]
    _, h_np = codec._homographies(h_matrix, b)
    h_all = np.concatenate(_gather_objects(h_np, group, dp))
    warp = (pick_warp_win(h_all, h_img, w_img),
            pick_warp_xwin(h_all, h_img, w_img))

    def agree(spreads):
        spreads = spreads.clone()
        dist.all_reduce(spreads, op=dist.ReduceOp.MAX, group=group)
        return spreads

    handle = codec._encode_device(x1, x2, h_matrix, warp=warp,
                                  agree_spreads=agree)
    parts = _gather_objects(codec._host_pieces(handle), group, dp)
    out = codec._containers(dict(handle, h_np=h_all), _merge_pieces(parts),
                            batch_container)
    out["enctime"] = time.perf_counter() - t0
    out["outliers"] = tuple(sum(p["outlier_counts"][e] for p in parts)
                            for e in range(2))
    return out


@torch.no_grad()
def split_decompress_fast_batch(codec, mesh, blob: bytes) -> dict:
    """decompress_fast_batch of a batch container split over the "data"
    axis: each rank decodes its contiguous share of the pairs, and every
    rank returns the whole batch's x1_hat, x2_hat, y1_hat, y2_hat."""
    dp, d, group = _data(mesh)
    off = _check_format(blob, codec.device)
    b = int(np.frombuffer(blob, np.uint32, 4, off + 4)[2])
    if b % dp:
        raise ValueError(f"a batch container of {b} pairs does not split "
                         f"over {dp} data ranks")
    n = b // dp
    out = codec.decompress_fast_batch(blob, pairs=slice(d * n, (d + 1) * n))
    return {k: _gather_batch(out[k], group, dp) for k in _OUTPUTS}


@torch.no_grad()
def split_compress_wavefront(codec, mesh, x1, x2, h_matrix) -> dict:
    """HESICPlusDeviceCodec.compress of the batch whose slice at this
    rank's "data" coordinate is x1, x2 (b, H, W, 3) and h_matrix: the
    transforms on the slice, the rest over the gathered batch.  Every
    rank returns the one process's blob."""
    dp, _, group = _data(mesh)
    start = time.perf_counter()
    x1, x2 = codec._to_device(x1), codec._to_device(x2)
    b, h_img, w_img = codec._check_size(x1)
    h, _ = codec._homographies(h_matrix, b)
    parts = codec.transforms_enc(x1, x2, h) + (h,)
    y1, y2, z1_sym, z2_sym, h = (_gather_batch(t, group, dp) for t in parts)
    return codec._compress_latents(y1, y2, z1_sym, z2_sym, h,
                                   h.cpu().numpy(), (h_img, w_img), start)


def _equal(name: str, got, want) -> None:
    got, want = (t.cpu().numpy() if torch.is_tensor(t) else np.asarray(t)
                 for t in (got, want))
    np.testing.assert_array_equal(got, want, err_msg=name)


def sharded_codec_roundtrip(mesh, size: int = 64, batch_per_device: int = 1,
                            seed: int = 0, arch: str = "hesic") -> dict:
    """One encode and decode of `arch` ('hesic', 'dsic' or 'hesic-plus',
    the last through the wavefront device codec) at the JAX function's
    tiny widths, with the batch split over the mesh's "data" axis; every
    rank builds the same seeded model and the global batch from
    RandomState(seed), and codes its slice.  Asserts that the decoded
    latents equal the encoder's, and that the container bytes and the
    decoded latents equal the one-process run's.  Returns {"pairs",
    "blob_bytes", "bpp_real"}."""
    from ..models import (DSIC, HESIC, DSICFastCodec, HESICFastCodec,
                          HESICPlus, HESICPlusDeviceCodec)
    if arch not in ("hesic", "dsic", "hesic-plus"):
        raise ValueError(f"unknown arch {arch!r}")
    dp, d, _ = _data(mesh)
    device = mesh_device(mesh)
    b = dp * batch_per_device
    rng = np.random.RandomState(seed)
    x1 = rng.rand(b, size, size, 3).astype(np.float32)
    x2 = rng.rand(b, size, size, 3).astype(np.float32)
    h = np.tile(np.eye(3, dtype=np.float32)[None], (b, 1, 1))
    mine = slice(d * batch_per_device, (d + 1) * batch_per_device)

    if arch == "hesic-plus":
        codec = HESICPlusDeviceCodec(HESICPlus(N=8, M=16, device=device),
                                     mm=8, groups=4)
        codec.update()
        out0 = codec.compress(x1, x2, h)                # one process
        rec0 = codec.decompress(out0["strings"])
        out1 = split_compress_wavefront(codec, mesh, x1[mine], x2[mine],
                                        h[mine])
        rec1 = codec.decompress(out1["strings"])
        blob0, blob1 = out0["strings"][0], out1["strings"][0]
        enc = (out1["y1_hat"], out1["y2_hat"])
    else:
        if arch == "dsic":
            codec = DSICFastCodec(DSIC(N=8, M=16, F=6, C=8, K=2,
                                       device=device), mm=8, codec_batch=b)
        else:
            codec = HESICFastCodec(HESIC(N=8, M=16, K=2, device=device),
                                   mm=8, codec_batch=b)
        codec.update()
        out0 = codec.compress_fast(x1, x2, h, batch_container=True)
        rec0 = codec.decompress_fast_batch(out0["blob"])
        out1 = split_compress_fast(codec, mesh, x1[mine], x2[mine], h[mine])
        rec1 = split_decompress_fast_batch(codec, mesh, out1["blob"])
        blob0, blob1 = out0["blob"], out1["blob"]
        hh, h_np = codec._homographies(h, b)
        y1h, y2h = codec.transforms_enc(
            codec._to_device(x1), codec._to_device(x2), hh,
            pick_warp_win(h_np, size, size))[:2]
        enc = (y1h.permute(0, 2, 3, 1).float(),
               y2h.permute(0, 2, 3, 1).float())

    # bit-exact round trip under the split: decoded latents == encoder's
    _equal("y1_hat against the encoder's", rec1["y1_hat"], enc[0])
    _equal("y2_hat against the encoder's", rec1["y2_hat"], enc[1])
    # equivalence with the one-process codec
    if blob1 != blob0:
        raise AssertionError(f"split encode produced different container "
                             f"bytes ({len(blob1)} vs {len(blob0)})")
    _equal("y1_hat against one process", rec1["y1_hat"], rec0["y1_hat"])
    _equal("y2_hat against one process", rec1["y2_hat"], rec0["y2_hat"])
    return {"pairs": b, "blob_bytes": len(blob1),
            "bpp_real": out1["bpp_real"]}
