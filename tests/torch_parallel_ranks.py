"""Gloo process groups for the port's parallel tests: a launcher and the
rank programs.

``launch(tmp_path, world, job)`` starts `world` subprocesses of this
file, each a rank (RANK and WORLD_SIZE in its environment, one CPU
thread), which meet through a ``file://`` store under `tmp_path`
(``init_process_group(..., timeout=GROUP_TIMEOUT)``), run ``JOBS[job]``,
and write their results to ``rank<r>.npz``.  A rank that hangs fails its
test through the subprocess timeout (RANK_TIMEOUT); no port is opened.
The ranks import numpy, torch and the port only: the tests that compare
them with the JAX package do so in their own process.

Shared inputs (the batch, the seeds) are built here, so a test computes
its one-process reference from the same ``train_inputs``.
"""

import datetime
import os
import subprocess
import sys

import numpy as np

GROUP_TIMEOUT = 60        # seconds: init_process_group and collectives
RANK_TIMEOUT = 240        # seconds: a rank process, start to exit
STEPS = 2
NOISE_SEED = 9
LMBDA = 1e-2


def launch(tmp_path, world: int, job: str,
           timeout: int = RANK_TIMEOUT) -> list:
    """Run ``JOBS[job]`` on `world` gloo ranks; returns each rank's
    results ({name: array}) in rank order.  Raises if a rank fails or
    outlives `timeout`."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    store = tmp_path / f"store-{job}-{world}"
    base = dict(os.environ, PYTHONPATH=root, CUDA_VISIBLE_DEVICES="",
                WORLD_SIZE=str(world), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), job, str(store),
         str(tmp_path)], env=dict(base, RANK=str(r)), cwd=root,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        raise AssertionError(f"{job} at world {world}: a rank outlived "
                             f"{timeout} s")
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"{job} rank {r}:\n{log[-4000:]}"
    out = []
    for r in range(world):
        with np.load(tmp_path / f"{job}-{world}-rank{r}.npz") as f:
            out.append({k: f[k] for k in f.files})
    return out


def train_inputs(stereo: bool, b: int = 4, hw: int = 64) -> dict:
    """The global batch (numpy, NCHW) of the train jobs."""
    rng = np.random.RandomState(0)
    if not stereo:
        return {"x": rng.rand(b, 3, hw, hw).astype(np.float32)}
    return {"x1": rng.rand(b, 3, hw, hw).astype(np.float32),
            "x2": rng.rand(b, 3, hw, hw).astype(np.float32),
            "h": np.tile(np.eye(3, dtype=np.float32)[None], (b, 1, 1))}


def tiny_model(arch: str, device="cpu"):
    from hesic_tpu_torch.models import HESIC, FactorizedPrior
    if arch == "hesic":
        return HESIC(N=8, M=16, K=2, device=device, seed=0)
    return FactorizedPrior(N=8, M=12, device=device, seed=0)


def eval_loss_fn(model, batch, generator):
    """The RD loss plus the aux loss of the eval forward (no noise)."""
    from hesic_tpu_torch.training import rate_distortion_loss
    out = model(batch["x"], training=False)
    rd = rate_distortion_loss(out, batch["x"], LMBDA)
    return rd["loss"] + model.aux_loss(), {"bpp": rd["bpp_loss"],
                                           "mse": rd["mse_loss"]}


def run_steps(model, step, batch) -> np.ndarray:
    """STEPS steps from one generator seeded NOISE_SEED; the losses."""
    import torch
    gen = torch.Generator().manual_seed(NOISE_SEED)
    return np.array([float(step(batch, gen)["loss"]) for _ in range(STEPS)])


def params_np(model, prefix: str = "p:") -> dict:
    return {prefix + k: v.detach().cpu().numpy().copy()
            for k, v in model.named_parameters()}


# ---- rank programs: each returns {name: array} ----

def _train(mesh, arch: str, loss_fn=None, params_file: str = None) -> dict:
    from hesic_tpu_torch.parallel import (make_parallel_train_step,
                                          shard_batch, shard_params,
                                          unshard_params)
    from hesic_tpu_torch.training import make_loss_fn, make_optimizer
    from hesic_tpu_torch.utils.persist import load_params, read_pickle
    model = tiny_model(arch)
    if params_file is not None:
        load_params(model, read_pickle(params_file))
    shard_params(mesh, model)
    chunks = {"chunk:" + k: np.array(v.shape) for k, v in
              model.named_parameters() if "parametrizations" in k}
    opt = make_optimizer(model, 1e-3, 1e-2)
    step = make_parallel_train_step(model, opt, loss_fn or make_loss_fn(LMBDA),
                                    mesh)
    batch = shard_batch(mesh, train_inputs(arch == "hesic"))
    losses = run_steps(model, step, batch)
    unshard_params(model)
    return {"losses": losses, **chunks, **params_np(model)}


def job_dp(mesh, tmp_path) -> dict:
    """World 2, mesh (2, 1): FactorizedPrior's DP step; shard_batch's
    slice; make_parallel_apply; the cross-package eval-loss step from
    JAX's weights; make_mesh's refusal of a mesh larger than the world."""
    import torch
    from hesic_tpu_torch.parallel import (make_mesh, make_parallel_apply,
                                          shard_batch)
    out = {"dp:" + k: v for k, v in _train(mesh, "prior").items()}
    out["slice"] = shard_batch(mesh, train_inputs(False))["x"].numpy()
    model = tiny_model("prior")
    apply = make_parallel_apply(model, mesh)
    res = apply(torch.from_numpy(out["slice"]))
    out["apply:x_hat"] = res["x_hat"].numpy()
    out["apply:lik_y"] = res["likelihoods"]["y"].numpy()
    jax_params = os.path.join(tmp_path, "jax_params.pkl")
    out.update({"jax:" + k: v for k, v in _train(
        mesh, "prior", eval_loss_fn, jax_params).items()})
    try:
        make_mesh((2, 2), device_type="cpu")
        out["too_big"] = np.array("no error")
    except ValueError as e:
        out["too_big"] = np.array(str(e))
    return out


def job_tp(mesh, tmp_path) -> dict:
    """World 4, mesh (2, 2): FactorizedPrior's and HESIC's DP x TP
    steps."""
    out = {"prior:" + k: v for k, v in _train(mesh, "prior").items()}
    out.update({"hesic:" + k: v for k, v in _train(mesh, "hesic").items()})
    return out


def job_codec(mesh, tmp_path) -> dict:
    """sharded_codec_roundtrip of each arch, 4 pairs a rank."""
    from hesic_tpu_torch.parallel import sharded_codec_roundtrip
    out = {}
    for arch in ("hesic", "dsic", "hesic-plus"):
        stats = sharded_codec_roundtrip(mesh, batch_per_device=4, arch=arch)
        for k, v in stats.items():
            out[f"{arch}:{k}"] = np.array(v)
    return out


def mixed_inputs(b: int = 8, hw: int = 64):
    """A batch whose halves make different choices alone: the first half
    flat images under the identity (grid mm 4, warp window 16 at the
    tiny HESIC), the second amplified noise under a 20-degree rotation
    (mm 8, window 64)."""
    rng = np.random.RandomState(0)
    x1 = rng.rand(b, hw, hw, 3).astype(np.float32)
    x2 = rng.rand(b, hw, hw, 3).astype(np.float32)
    half = b // 2
    x1[:half] = x2[:half] = 0.5
    x1[half:] *= 8
    x2[half:] *= 8
    th = np.deg2rad(20)
    rot = np.array([[np.cos(th), -np.sin(th), 10.0],
                    [np.sin(th), np.cos(th), -6.0], [0.0, 0.0, 1.0]],
                   np.float32)
    h = np.tile(np.eye(3, dtype=np.float32)[None], (b, 1, 1))
    h[half:] = rot
    return x1, x2, h


def _bytes(blobs) -> np.ndarray:
    return np.frombuffer(b"".join(blobs), np.uint8)


def job_mixed(mesh, tmp_path) -> dict:
    """World 2: the split fast codec on mixed_inputs, against the one
    process's batch and per-pair containers and decode; and the header
    (writer, mm1, mm2, win, xwin byte) this rank's pairs pick alone."""
    from hesic_tpu_torch.models import HESIC, HESICFastCodec
    from hesic_tpu_torch.parallel import (split_compress_fast,
                                          split_decompress_fast_batch)
    x1, x2, h = mixed_inputs()
    b = x1.shape[0] // mesh.shape[0]
    d = mesh.get_local_rank("data")
    mine = slice(d * b, (d + 1) * b)
    codec = HESICFastCodec(HESIC(N=8, M=16, K=2, device="cpu"), mm=32,
                           codec_batch=x1.shape[0])
    codec.update()
    one = codec.compress_fast(x1, x2, h, batch_container=True)["blob"]
    split = split_compress_fast(codec, mesh, x1[mine], x2[mine], h[mine])
    rec = split_decompress_fast_batch(codec, mesh, split["blob"])
    ref = codec.decompress_fast_batch(one)
    alone = codec.compress_fast(x1[mine], x2[mine], h[mine],
                                batch_container=True)["blob"]
    pairs = split_compress_fast(codec, mesh, x1[mine], x2[mine], h[mine],
                                batch_container=False)["blobs"]
    return {"one": _bytes([one]), "split": _bytes([split["blob"]]),
            "pairs_one": _bytes(codec.compress_fast(x1, x2, h)["blobs"]),
            "pairs_split": _bytes(pairs), "alone_head": _bytes([alone[:5]]),
            **{f"rec:{k}": v.numpy() for k, v in rec.items()},
            **{f"ref:{k}": ref[k].numpy() for k in rec}}


JOBS = {"dp": job_dp, "tp": job_tp, "codec": job_codec, "mixed": job_mixed}
MESHES = {"dp": lambda w: (w, 1), "tp": lambda w: (2, w // 2),
          "codec": lambda w: (w, 1), "mixed": lambda w: (w, 1)}


def main(job: str, store: str, tmp_path: str) -> None:
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT))
    try:
        from hesic_tpu_torch.parallel import make_mesh
        mesh = make_mesh(MESHES[job](world), device_type="cpu")
        out = JOBS[job](mesh, tmp_path)
        np.savez(os.path.join(tmp_path, f"{job}-{world}-rank{rank}.npz"),
                 **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:])
