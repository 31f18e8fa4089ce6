"""Port: hesic_tpu_torch.parallel's mesh, placement rule and data- and
tensor-parallel train step on gloo process groups on the CPU, mirroring
tests/test_training_parallel.py:73-213.

The ranks are subprocesses (tests/torch_parallel_ranks.py: a ``file://``
store under tmp_path, a 60 s group timeout, a 240 s process timeout),
one launch per mesh shape shared by the checks of that shape: world 2,
mesh (2, 1) and world 4, mesh (2, 2).  The one-process references run in
this process with ``training.make_train_step``.

Bounds, JAX's own (tests/test_training_parallel.py): losses rtol 1e-5;
parameters rtol 1e-4 / atol 1e-6.  The cross-package check (the eval
loss from JAX's weights, JAX's ``make_parallel_train_step`` on a (2, 1)
mesh of its CPU devices) takes tests/test_torch_training.py's bounds:
losses rtol 1e-4, parameters per tensor within 5e-2 of the most JAX's
steps moved it.  About 35 s on the CPU (the two launches run ~10 s and
~15 s; JAX's jit ~10 s).
"""

import pickle

import numpy as np
import pytest
import torch

from torch_parallel_ranks import (LMBDA, STEPS, eval_loss_fn, launch,
                                  params_np, run_steps, tiny_model,
                                  train_inputs)

LOSS_RTOL = 1e-5
PARAM_RTOL = 1e-4
PARAM_ATOL = 1e-6
JAX_LOSS_RTOL = 1e-4
PARAM_REL = 5e-2


def _params(res: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in res.items()
            if k.startswith(prefix)}


def _close_params(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=k)


@pytest.fixture(scope="module")
def one_process():
    """{arch: {"losses", "p:<name>"...}} of STEPS make_train_step steps
    on the whole batch, on one thread as the ranks run: Adam turns the
    rounding of a near-zero gradient element into a step of up to lr, so
    the reference takes the ranks' reduction orders where it can."""
    from hesic_tpu_torch.training import (make_loss_fn, make_optimizer,
                                          make_train_step)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {}
    try:
        for arch in ("prior", "hesic"):
            model = tiny_model(arch)
            opt = make_optimizer(model, 1e-3, 1e-2)
            step = make_train_step(model, opt, make_loss_fn(LMBDA))
            batch = {k: torch.from_numpy(v)
                     for k, v in train_inputs(arch == "hesic").items()}
            out[arch] = {"losses": run_steps(model, step, batch),
                         **params_np(model)}
    finally:
        torch.set_num_threads(threads)
    return out


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return tmp_path_factory.mktemp("parallel_train")


@pytest.fixture(scope="module")
def jax_run(workdir):
    """JAX's FactorizedPrior(N=8, M=12) at its init, written for the ranks
    to carry, and STEPS of JAX's parallel step of the eval loss on a
    (2, 1) mesh: (initial params, losses, final params)."""
    import jax
    import jax.numpy as jnp
    from hesic_tpu.models import FactorizedPrior
    from hesic_tpu.parallel import (make_mesh, make_parallel_train_step,
                                    shard_batch, shard_params)
    from hesic_tpu.training import (TrainState, make_optimizer,
                                    rate_distortion_loss)
    module = FactorizedPrior(N=8, M=12)
    x = train_inputs(False)["x"].transpose(0, 2, 3, 1)
    params = module.init({"params": jax.random.PRNGKey(0),
                          "noise": jax.random.PRNGKey(1)},
                         jnp.asarray(x[:1]), training=True)["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    with open(workdir / "jax_params.pkl", "wb") as f:
        pickle.dump({"params": params}, f)

    def loss_fn(module, p, batch, rng):
        out = module.apply({"params": p}, batch["x"], training=False)
        rd = rate_distortion_loss(out, batch["x"], lmbda=LMBDA)
        aux = module.apply({"params": p}, method="aux_loss")
        return rd["loss"] + aux, {"bpp": rd["bpp_loss"]}

    mesh = make_mesh((2, 1))
    tx = make_optimizer(1e-3, 1e-2)
    state = TrainState.create(shard_params(mesh, params), tx)
    batch = shard_batch(mesh, {"x": x})
    step = make_parallel_train_step(module, tx, loss_fn, mesh)
    losses = []
    for i in range(STEPS):
        state, metrics = step(state, batch, jax.random.PRNGKey(i))
        losses.append(float(metrics["loss"]))
    return (params, np.array(losses),
            jax.tree_util.tree_map(np.asarray, state.params))


@pytest.fixture(scope="module")
def dp(workdir, jax_run):
    return launch(workdir, 2, "dp")


@pytest.fixture(scope="module")
def tp(workdir):
    return launch(workdir, 4, "tp")


# ---- no process group ----

def _marked(shape):
    """An array whose values are the index along the last axis."""
    return np.broadcast_to(np.arange(shape[-1], dtype=np.float32),
                           shape).copy()


@pytest.mark.parametrize("arch", ["prior", "hesic"])
def test_param_sharding_is_jax_rule_on_port_layout(arch):
    """The port shards a parameter exactly where JAX shards its leaf, on
    the axis JAX's last axis lands on under from_jax (found by carrying a
    leaf whose values mark that axis)."""
    import jax
    import jax.numpy as jnp
    from hesic_tpu.models import HESIC, FactorizedPrior
    from hesic_tpu.parallel import make_mesh, param_sharding as j_rule
    from hesic_tpu_torch.parallel import param_sharding
    from hesic_tpu_torch.utils.from_jax import hesic_from_jax
    if arch == "hesic":
        module = HESIC(N=8, M=16, K=2)
        args = (jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 64, 64, 3)),
                jnp.eye(3)[None])
    else:
        module = FactorizedPrior(N=8, M=12)
        args = (jnp.zeros((1, 64, 64, 3)),)
    shapes = jax.eval_shape(lambda: module.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        *args, training=True)["params"])
    spec = j_rule(make_mesh((4, 2)), shapes)
    leaves = jax.tree_util.tree_leaves_with_path(spec)
    sharded = {jax.tree_util.keystr(p): s.spec[-1] == "model"
               for p, s in leaves if len(s.spec)}
    marked = jax.tree_util.tree_map(lambda s: _marked(s.shape), shapes)
    model = tiny_model(arch)
    carried = hesic_from_jax(marked, model)
    got = param_sharding({"data": 4, "model": 2}, model)
    assert sorted(got) == sorted(carried)
    want = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(marked):
        keys = [str(getattr(k, "key", k)) for k in path]
        name = ".".join(keys[:-1] + [{"kernel": "weight", "scale": "weight"}
                                     .get(keys[-1], keys[-1])])
        if not sharded.get(jax.tree_util.keystr(path)):
            want[name] = None
            continue
        t = carried[name].numpy()
        varying = [a for a in range(t.ndim)
                   if not (np.diff(t, axis=a) == 0).all()]
        assert len(varying) == 1, (name, varying)
        want[name] = varying[0]
    assert got == want
    assert sum(a is not None for a in got.values()) >= 8


@pytest.mark.parametrize("dp_", [1, 2, 4])
@pytest.mark.parametrize("layout", ["nchw", "bottleneck"])
def test_noise_under_the_split_equals_one_process(layout, dp_):
    """Each rank's draw under data_split, put back in batch order, is the
    one process's draw of the whole batch; dp 1 draws exactly what the
    one process draws."""
    from hesic_tpu_torch.entropy_models import EntropyBottleneck
    from hesic_tpu_torch.ops import quantize
    from hesic_tpu_torch.ops.ops import data_split
    x = torch.randn(8, 4, 3, 5, generator=torch.Generator().manual_seed(1))
    if layout == "nchw":
        def draw(t):
            return quantize(t, "noise",
                            generator=torch.Generator().manual_seed(3))
    else:
        eb = EntropyBottleneck(4)

        def draw(t):
            return eb(t, True, torch.Generator().manual_seed(3))[0]
    want = draw(x)
    b = 8 // dp_
    parts = []
    for d in range(dp_):
        with data_split(d, dp_, b):
            parts.append(draw(x[d * b:(d + 1) * b]))
    assert torch.equal(torch.cat(parts), want)


def test_make_mesh_needs_a_process_group():
    import torch.distributed as dist
    from hesic_tpu_torch.parallel import make_mesh
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh((1, 1), device_type="cpu")
    assert not dist.is_initialized()


# ---- world 2, mesh (2, 1) ----

def test_dp_matches_one_process(dp, one_process):
    """Losses and parameters after DP steps == one-process steps."""
    want = one_process["prior"]
    for r in dp:
        np.testing.assert_allclose(r["dp:losses"], want["losses"],
                                   rtol=LOSS_RTOL)
        _close_params(_params(r, "dp:p:"), _params(want, "p:"))


def test_shard_batch_slices(dp):
    x = train_inputs(False)["x"]
    for d, r in enumerate(dp):
        np.testing.assert_array_equal(r["slice"], x[2 * d:2 * d + 2])


def test_parallel_apply_gathers_the_batch(dp):
    model = tiny_model("prior")
    with torch.no_grad():
        want = model(torch.from_numpy(train_inputs(False)["x"]))
    for r in dp:
        np.testing.assert_allclose(r["apply:x_hat"], want["x_hat"].numpy(),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r["apply:lik_y"],
                                   want["likelihoods"]["y"].numpy(),
                                   rtol=1e-5, atol=1e-9)


def test_make_mesh_refuses_a_mesh_beyond_the_world(dp):
    for r in dp:
        assert str(r["too_big"]) == "mesh (2, 2) needs 4 devices, have 2"


def test_dp_step_against_jax_parallel_step(dp, jax_run):
    """The eval loss's DP step from carried weights, against JAX's
    make_parallel_train_step on a (2, 1) mesh of its CPU devices."""
    from hesic_tpu_torch.utils.from_jax import hesic_from_jax
    start, losses, final = jax_run
    model = tiny_model("prior")
    want = hesic_from_jax(final, model)
    before = hesic_from_jax(start, model)
    for r in dp:
        np.testing.assert_allclose(r["jax:losses"], losses,
                                   rtol=JAX_LOSS_RTOL)
        for name, w in want.items():
            limit = PARAM_REL * float((w - before[name]).abs().max())
            err = float(np.abs(r["jax:p:" + name] - w.numpy()).max())
            assert err <= limit, (name, err, limit)


# ---- world 4, mesh (2, 2) ----

def test_tp2_matches_tp1(tp, dp):
    """A model axis of 2 changes neither the losses nor the updates."""
    for r in tp:
        np.testing.assert_allclose(r["prior:losses"], dp[0]["dp:losses"],
                                   rtol=LOSS_RTOL)
        _close_params(_params(r, "prior:p:"), _params(dp[0], "dp:p:"))


def test_tp_really_shards_kernels(tp):
    """g_a_2's weight (the conv after the first GDN) holds half its output
    channels on every rank of the (2, 2) mesh."""
    full = tiny_model("prior").g_a_2.weight.shape
    for r in tp:
        chunk = tuple(r["prior:chunk:g_a_2.parametrizations.weight."
                        "original"])
        assert chunk == (full[0] // 2,) + tuple(full[1:])


def test_hesic_dp_tp_step_matches_one_process(tp, one_process):
    want = one_process["hesic"]
    for r in tp:
        np.testing.assert_allclose(r["hesic:losses"], want["losses"],
                                   rtol=LOSS_RTOL)
        _close_params(_params(r, "hesic:p:"), _params(want, "p:"))
