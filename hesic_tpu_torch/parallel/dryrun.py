"""The multi-device dry run of the JAX package (``__graft_entry__.py``'s
``dryrun_multichip``) through the port: one HESIC(N=8, M=16, K=2) train
step over a (data, model) mesh at 64x64, then the split round trips of
the tiny HESIC, DSIC and HESIC+ codecs (``sharded_codec_roundtrip``, each
asserting its round trip bit-exact and its container equal to the one
process's), a line each.

Run it under torchrun, one process a card (``--cpu``: gloo on the CPU):

    torchrun --nproc_per_node=1 -m hesic_tpu_torch.parallel.dryrun
    torchrun --nproc_per_node=4 -m hesic_tpu_torch.parallel.dryrun --cpu

As in the JAX dry run, the mesh is (n/2, 2) for an even world n >= 2 and
(n, 1) otherwise, the train batch one pair a data rank, and the codecs'
mesh (n, 1).
"""

from __future__ import annotations

import argparse
import datetime

import numpy as np
import torch
import torch.distributed as dist

from .codec import sharded_codec_roundtrip
from .mesh import (make_mesh, make_parallel_train_step, mesh_device,
                   shard_batch, shard_params)

SIZE = 64


def dry_run(train_mesh, codec_mesh) -> None:
    """The dry run's train step on `train_mesh` and its three split round
    trips on `codec_mesh`; rank 0 prints a line each."""
    from ..models import HESIC
    from ..training import make_loss_fn, make_optimizer
    dp, tp = train_mesh.shape
    n = dp * tp
    device = mesh_device(train_mesh)
    rng = np.random.RandomState(0)
    batch = {"x1": rng.rand(dp, 3, SIZE, SIZE).astype(np.float32),
             "x2": rng.rand(dp, 3, SIZE, SIZE).astype(np.float32),
             "h": np.tile(np.eye(3, dtype=np.float32)[None], (dp, 1, 1))}
    model = shard_params(train_mesh, HESIC(N=8, M=16, K=2, device=device))
    step = make_parallel_train_step(model, make_optimizer(model),
                                    make_loss_fn(1e-2), train_mesh)
    gen = torch.Generator(device=device).manual_seed(2)
    loss = float(step(shard_batch(train_mesh, batch), gen)["loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss in the dry run: {loss}")
    say = print if dist.get_rank() == 0 else (lambda *a: None)
    say(f"dryrun_multichip(n={n}, mesh=({dp},{tp})): loss={loss:.4f} OK")
    for arch, what in (("hesic", "codec"), ("dsic", "dsic codec"),
                       ("hesic-plus", "wavefront")):
        stats = sharded_codec_roundtrip(codec_mesh, SIZE, arch=arch)
        say(f"dryrun_multichip {what}(n={n}): {stats['pairs']} pairs "
            f"sharded enc+dec, {stats['blob_bytes']} B, bit-exact vs "
            f"single-device OK")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="gloo on the CPU instead of NCCL on the cards")
    args = ap.parse_args(argv)
    device_type = "cpu" if args.cpu else "cuda"
    dist.init_process_group("gloo" if args.cpu else "nccl",
                            timeout=datetime.timedelta(seconds=300))
    try:
        n = dist.get_world_size()
        tp = 2 if n % 2 == 0 else 1
        dry_run(make_mesh((n // tp, tp), device_type),
                make_mesh((n, 1), device_type))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
