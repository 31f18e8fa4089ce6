"""Port: module-level public functions and methods of the JAX package that
the port lacked (ROADMAP C13), each held against the JAX package on the
CPU with the same numpy inputs from a seed.

* codecs/device_rans.py: ``grid_from_flat``, ``gather_intervals``,
  ``intervals_from_freq``, the interleaved coder
  (``rans_encode_interleaved``, ``rans_decode_interleaved``: words,
  counts, states and symbols, both ways) bit-equal; the layout the card's
  route gives kernels 2 and 3 (``grid_rans.encode_intervals_cuda``,
  ``decode_rows_cuda``) checked here with the kernels' plain twins in
  their place.  ``quantize_pmf_device`` bit-equal on PMFs whose row sums
  are exact in float32 (any summation order), on random rows of up to 17
  bins, and, on longer random rows, on every row whose total equals
  XLA's (XLA:CPU sums longer rows in another order than the port's
  ascending one).
* codecs/host_rans.py: ``RansDecoder.decode_with_indexes`` decodes a
  stream of the JAX package's encoder to its symbols, as JAX's method.
* models/ar_device.py: ``PROB_BITS``; ``wavefront_encode`` /
  ``wavefront_decode`` at HESIC+'s test widths (M=24 latents of 64x64
  images, B=2, mm 8, 4 groups; eye 1 without and eye 2 with the 24-wide
  post input; ordinary and amplified latents, which escape the grid) on
  tests/test_torch_wavefront.py's seeded weights.  Residuals, escape
  counts and word counts equal; y_hat within 1e-5, the bound
  tests/test_torch_wavefront.py states.  The teacher's intervals lie
  within its +-2 counts of JAX's (the two Phi implementations differ in
  the last bits), so the words and states are held bit-equal lane by
  lane wherever a lane's intervals equal JAX's (rANS lanes are
  independent; 6 to 11 of the 24 lanes here, at least 4 required), and
  as a whole against JAX's coder run on the port's intervals.  The
  port's decode of its own stream gives its teacher's y_hat exactly;
  JAX's decode of JAX's stream agrees within 1e-5.
* codecs/device_rans.py ``pack_stream``, the priors' ``eb_medians``,
  models/dsic.py ``EnhancementSelf``: byte-equal, equal, built.
* Every public top-level function, class (with its public methods) and
  upper-case constant of each JAX module is in the port's module of the
  same name, but for ``ELSEWHERE``, each with its reason.
* entropy_models: ``EntropyBottleneck.target`` equal.

About 35 s on the CPU.
"""

import ast
import importlib
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hesic_tpu.codecs import device_rans as jdr
from hesic_tpu.codecs.rans import RansDecoder as JRansDecoder
from hesic_tpu.codecs.rans import RansEncoder as JRansEncoder
from hesic_tpu.models import ar_device as jad
from hesic_tpu_torch.codecs import device_rans, grid_rans
from hesic_tpu_torch.codecs.host_rans import RansDecoder
from hesic_tpu_torch.models import ar_device
from test_torch_wavefront import _setup, _weights

torch.set_num_threads(2)


def _j(a):
    return np.asarray(a)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---- quantize_pmf_device ----

@pytest.mark.parametrize("s,dim", [(9, -1), (33, -1), (129, -1), (33, 1)])
def test_quantize_pmf_exact_sums(s, dim):
    """Bins of k / 2^10 (k < 2^10): every partial sum is exact, so the
    rows cannot depend on the summation order."""
    rng = np.random.RandomState(s)
    shape = (300, s) if dim == -1 else (20, s, 15)
    pmf = (rng.randint(0, 1024, shape) / 1024.0).astype(np.float32)
    pmf[rng.rand(*shape) < 0.1] = 0
    pmf[0] = 0                              # an all-zero row (or slab)
    got = device_rans.quantize_pmf_device(_t(pmf), dim).numpy()
    want = _j(jdr.quantize_pmf_device(jnp.asarray(pmf), dim))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32
    assert (got.sum(dim) == 1 << 16).all() and (got >= 1).all()


@pytest.mark.parametrize("s", [3, 9, 17, 33, 129])
def test_quantize_pmf_random(s):
    rng = np.random.RandomState(100 + s)
    pmf = (rng.rand(2000, s) ** 3).astype(np.float32)
    got = device_rans.quantize_pmf_device(_t(pmf)).numpy()
    want = _j(jdr.quantize_pmf_device(jnp.asarray(pmf)))
    # a row whose total is XLA's gives XLA's integers
    seq = pmf[:, 0].copy()
    for k in range(1, s):
        seq = (seq + pmf[:, k]).astype(np.float32)
    same = seq == _j(jnp.sum(jnp.asarray(pmf), axis=-1))
    if s <= 17:
        assert same.all()
    assert same.mean() > 0.2
    np.testing.assert_array_equal(got[same], want[same])


# ---- the interleaved coder and its helpers ----

@pytest.mark.parametrize("n,lanes", [(1000, 128), (1024, 128), (37, 8)])
def test_grid_from_flat(n, lanes):
    arr = np.arange(n, dtype=np.int32) * 3 + 1
    g, v = device_rans.grid_from_flat(_t(arr), lanes, 7)
    jg, jv = jdr.grid_from_flat(jnp.asarray(arr), lanes, jnp.int32(7))
    np.testing.assert_array_equal(g.numpy(), _j(jg))
    np.testing.assert_array_equal(v.numpy(), _j(jv))


def _intervals(seed, n, s):
    """n symbols with their quantized rows: (rows (n, S), CDF rows (n,
    S+1), symbols (n,)) int32 numpy."""
    rng = np.random.RandomState(seed)
    pmf = (rng.rand(n, s) ** 4).astype(np.float32)
    rows = _j(jdr.quantize_pmf_device(jnp.asarray(pmf)))
    cdf = _j(jdr.freq_to_cdf(jnp.asarray(rows)))
    sym = np.array([rng.choice(s, p=r / r.sum()) for r in rows], np.int32)
    return rows, cdf, sym


def test_interval_helpers():
    rows, cdf, sym = _intervals(1, 500, 17)
    want = [_j(a) for a in jdr.gather_intervals(jnp.asarray(cdf),
                                                jnp.asarray(sym))]
    got = [a.numpy() for a in device_rans.gather_intervals(_t(cdf),
                                                           _t(sym))]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    f3 = rows.reshape(20, 25, 17)
    s3 = sym.reshape(20, 25)
    want = [_j(a) for a in jdr.intervals_from_freq(jnp.asarray(f3),
                                                   jnp.asarray(s3))]
    got = [a.numpy() for a in device_rans.intervals_from_freq(_t(f3),
                                                              _t(s3))]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == np.int32
    np.testing.assert_array_equal(got[0].reshape(-1), _j(jdr.gather_intervals(
        jnp.asarray(cdf), jnp.asarray(sym))[0]))


def _twins_for_kernels(monkeypatch):
    """Route grid_rans' CUDA entries to their plain twins, so the card's
    interval layout runs here."""
    monkeypatch.setattr(grid_rans, "rans_encode_grid_cuda",
                        grid_rans.rans_encode_grid_plain)
    monkeypatch.setattr(grid_rans, "rans_decode_grid_cuda",
                        grid_rans.rans_decode_grid_plain)


@pytest.mark.parametrize("n,lanes,s", [(1000, 128, 17), (1024, 128, 9),
                                       (37, 8, 65)])
def test_interleaved_coder_against_jax(n, lanes, s, monkeypatch):
    _, cdf, sym = _intervals(n + s, n, s)
    starts, freqs = (_j(a) for a in jdr.gather_intervals(jnp.asarray(cdf),
                                                         jnp.asarray(sym)))
    jw, jc, js = (_j(a) for a in jdr.rans_encode_interleaved(
        jnp.asarray(starts), jnp.asarray(freqs), lanes))
    w, c, st = device_rans.rans_encode_interleaved(_t(starts), _t(freqs),
                                                   lanes)
    np.testing.assert_array_equal(w.numpy(), jw)
    np.testing.assert_array_equal(c.numpy(), jc)
    np.testing.assert_array_equal(st.numpy(), js.astype(np.int64))
    # both decoders, each on the other's streams
    got = device_rans.rans_decode_interleaved(_t(jw), _t(jc),
                                              _t(js.astype(np.int64)),
                                              _t(cdf), n, lanes)
    np.testing.assert_array_equal(got.numpy(), sym)
    back = jdr.rans_decode_interleaved(
        jnp.asarray(w.numpy()), jnp.asarray(c.numpy()),
        jnp.asarray(st.numpy().astype(np.uint32)), jnp.asarray(cdf), n,
        lanes)
    np.testing.assert_array_equal(_j(back), sym)
    # the card's route: intervals as kernel 2's rows, a launch per lane
    # length; kernel 3 on the CDF rows' frequencies, every slot decoded
    _twins_for_kernels(monkeypatch)
    kw, kc, kst = grid_rans.encode_intervals_cuda(_t(starts), _t(freqs),
                                                  lanes)
    np.testing.assert_array_equal(kw.numpy(), jw)
    np.testing.assert_array_equal(kc.numpy(), jc)
    np.testing.assert_array_equal(kst.numpy(), js.astype(np.int64))
    t_steps = -(-n // lanes)
    rows = np.concatenate([cdf, np.repeat(cdf[:1], t_steps * lanes - n, 0)])
    syms = grid_rans.decode_rows_cuda(_t(jw), _t(jc),
                                      _t(js.astype(np.int64)), _t(rows),
                                      lanes)
    np.testing.assert_array_equal(syms.numpy()[:n], sym)


def test_ransdecoder_decode_with_indexes():
    rng = np.random.RandomState(4)
    pmfs = rng.rand(3, 12).astype(np.float64) ** 2
    pmfs /= pmfs.sum(1, keepdims=True)
    from hesic_tpu_torch.codecs import pmf_to_quantized_cdf
    cdfs = np.zeros((3, 13), np.int32)
    for i, p in enumerate(pmfs):
        cdfs[i] = pmf_to_quantized_cdf(p.tolist(), 16)
    sizes = np.full(3, 13, np.int32)
    offsets = np.array([-5, 0, -2], np.int32)
    idx = rng.randint(0, 3, 400).astype(np.int32)
    sym = (rng.randint(0, 11, 400) + offsets[idx]).astype(np.int32)
    blob = JRansEncoder().encode_with_indexes(sym, idx, cdfs, sizes,
                                              offsets)
    got = RansDecoder().decode_with_indexes(blob, idx, cdfs, sizes, offsets)
    want = JRansDecoder().decode_with_indexes(blob, idx, cdfs, sizes,
                                              offsets)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, sym)


# ---- the wavefront pass and its stream ----

B, HY, WY, M, MM, GROUPS = 2, 4, 4, 24, 8, 4


def test_prob_bits():
    assert ar_device.PROB_BITS == jad.PROB_BITS == 16


@pytest.mark.parametrize("q_dim", [0, M], ids=["eye1", "eye2-post"])
@pytest.mark.parametrize("gain", [1.0, 8.0], ids=["plain", "escapes"])
def test_wavefront_encode_decode_against_jax(q_dim, gain):
    w, pre, post, y = _setup(3, B, HY, WY, M, MM, GROUPS, q_dim)
    y = (y * gain).astype(np.float32)
    jpost = jnp.asarray(post) if q_dim else None
    tpost = _t(post) if q_dim else None
    jw, jc, js, jy, jr, jn = jad.wavefront_encode(
        _weights(w, "jax"), jnp.asarray(y), jnp.asarray(pre), jpost, MM,
        GROUPS)
    jw, jc, js, jy, jr = (_j(a) for a in (jw, jc, js, jy, jr))
    tw, tc, ts, ty, tr, tn = ar_device.wavefront_encode(
        _weights(w, "torch"), _t(y), _t(pre), tpost, MM, GROUPS)
    assert tw.shape == jw.shape and tw.dtype == torch.int32
    np.testing.assert_array_equal(tr.numpy(), jr)
    assert tn == jn and (tn > 0) == (gain > 1)
    np.testing.assert_array_equal(tc.numpy(), jc)
    assert np.abs(ty.numpy() - jy).max() < 1e-5

    # the teacher's intervals, JAX's and the port's
    lanes = jw.shape[0]
    zimg = jnp.zeros((B, HY, WY, M), jnp.int32)
    zl = jnp.zeros((lanes,), jnp.int32)
    j_post = jpost if q_dim else jnp.zeros((B, HY, WY, 0), jnp.float32)
    jst, jfr = (_j(a) for a in jad.ar_wavefront(
        _weights(w, "jax"), jnp.asarray(pre), j_post, jnp.asarray(y), zimg,
        zimg, jnp.zeros((lanes, 1), jnp.int32), zl, zl.astype(jnp.uint32),
        jnp.bool_(True), HY, WY, MM, GROUPS)[:2])
    from hesic_tpu_torch.models.wavefront import ar_wavefront
    tst, tfr = (a.numpy() for a in ar_wavefront(
        _weights(w, "torch"), _t(pre), tpost, _t(y), None, None, None, None,
        None, True, MM, GROUPS)[:2])
    valid = ar_device.wavefront_valid_mask(HY, WY, B, GROUPS, M).numpy()
    assert np.abs(tst - jst)[valid].max() <= 2
    assert np.abs(tfr - jfr)[valid].max() <= 2
    # lanes whose intervals equal JAX's: their streams are JAX's
    same = ((tst == jst) & (tfr == jfr)).all(axis=0)
    assert same.sum() >= 4
    np.testing.assert_array_equal(tw.numpy()[same], jw[same])
    np.testing.assert_array_equal(ts.numpy()[same],
                                  js[same].astype(np.int64))
    # the whole stream: JAX's coder on the port's intervals
    cw, cc, cs = (_j(a) for a in jdr.rans_encode_grid(
        jnp.asarray(tst.astype(np.uint32)), jnp.asarray(tfr.astype(
            np.uint32)), jnp.asarray(valid)))
    np.testing.assert_array_equal(tw.numpy(), cw)
    np.testing.assert_array_equal(tc.numpy(), cc)
    np.testing.assert_array_equal(ts.numpy(), cs.astype(np.int64))

    # decode, the escapes through the corrections
    esc = np.abs(tr.numpy()) > MM
    cm = _t(esc.astype(np.int32)) if esc.any() else None
    cv = _t(np.where(esc, tr.numpy(), 0).astype(np.int32)) if esc.any() \
        else None
    yd = ar_device.wavefront_decode(_weights(w, "torch"), _t(pre), tw, tc,
                                    ts, tpost, cm, cv, MM, GROUPS, m=M)
    torch.testing.assert_close(yd, ty, rtol=0, atol=0)
    jesc = np.abs(jr) > MM
    jyd = _j(jad.wavefront_decode(
        _weights(w, "jax"), jnp.asarray(pre), jnp.asarray(jw),
        jnp.asarray(jc), jnp.asarray(js), jpost,
        jnp.asarray(jesc.astype(np.int32)) if jesc.any() else None,
        jnp.asarray(np.where(jesc, jr, 0).astype(np.int32))
        if jesc.any() else None, MM, GROUPS))
    assert np.abs(yd.numpy() - jyd).max() < 1e-5
    with pytest.raises(ValueError):
        ar_device.wavefront_decode(_weights(w, "torch"), _t(pre), tw, tc,
                                   ts, tpost, mm=MM, groups=GROUPS, m=M + 8)


def test_entropy_bottleneck_target():
    from hesic_tpu.entropy_models import EntropyBottleneck as JEB
    from hesic_tpu_torch.entropy_models import EntropyBottleneck
    for tail in (1e-9, 1e-3):
        got = EntropyBottleneck(4, tail_mass=tail).target
        want = _j(JEB(channels=4, tail_mass=tail).target)
        assert got.dtype == torch.float32 and got.shape == (3,)
        np.testing.assert_array_equal(got.numpy(), want)


def test_pack_stream():
    rng = np.random.RandomState(6)
    counts = rng.randint(0, 9, 13).astype(np.int32)
    words = rng.randint(0, 1 << 16, (13, 10)).astype(np.int32)
    states = rng.randint(1 << 16, 1 << 31, 13).astype(np.uint32)
    blob = device_rans.pack_stream(words, counts, states)
    assert blob == jdr.pack_stream(words, counts, states)
    back = device_rans.unpack_stream(blob + b"tail")
    cap = back[0].shape[1]
    keep = np.arange(cap)[None, :] < counts[:, None]
    np.testing.assert_array_equal(back[0][keep], words[:, :cap][keep])
    np.testing.assert_array_equal(back[1], counts)
    np.testing.assert_array_equal(back[2], states)
    assert back[3] == len(blob)


def test_priors_eb_medians_and_enhancement_self():
    from hesic_tpu_torch.models.dsic import (EnhancementSelf,
                                             IndependentEnhancementNoWarp)
    from hesic_tpu_torch.models.priors import (
        FactorizedPrior, JointAutoregressiveHierarchicalPriors,
        MeanScaleHyperprior, ScaleHyperprior)
    for cls in (FactorizedPrior, ScaleHyperprior, MeanScaleHyperprior,
                JointAutoregressiveHierarchicalPriors):
        model = cls(N=8, M=8, device="cpu", seed=0)
        med = model.eb_medians()
        assert list(med) == ["entropy_bottleneck"]
        torch.testing.assert_close(
            med["entropy_bottleneck"],
            model.entropy_bottleneck.quantiles[:, 0, 1], rtol=0, atol=0)
    enh = EnhancementSelf(torch.Generator().manual_seed(0))
    assert enh.Conv_0.weight.shape[1] == 3
    x = torch.rand(1, 3, 16, 16)
    assert enh(x).shape == x.shape
    pair = IndependentEnhancementNoWarp()
    assert isinstance(pair.EnhancementSelf_0, EnhancementSelf)


# ---- every public module-level name and method (C13's walk) ----

ROOT = pathlib.Path(__file__).resolve().parents[1]
# JAX module -> the port's, where the file name differs
RENAMED = {"codecs/rans.py": "codecs/host_rans.py",
           "geometry/fast_warp.py": "geometry/warp.py"}
# (JAX module, name): why the port has no such name there
ELSEWHERE = {
    ("codecs/build.py", "SRC"): "the JAX build's one C++ source; the "
                                "port's build.SOURCES names its six",
    ("geometry/fast_warp.py", "warp_perspective_mxu"): "the TPU's one-hot "
        "matmul warp; the port warps by a gather (ROADMAP A)",
    ("models/ar_device.py", "ar_wavefront"): "the level scan is "
        "models/wavefront.py's ar_wavefront (kernel 5 and its twin)",
    ("models/base.py", "CompressionModel.apply"): "flax's apply; the "
        "port's codec holds a torch module",
    ("models/base.py", "CompressionModel.init"): "flax's init; the port's "
        "models initialise in their constructors",
    ("models/base.py", "CompressionModel.jit"): "the JAX codec's jit "
        "cache; the port runs eagerly",
    ("models/base.py", "TogetherCodec.inner"): "an instance attribute of "
        "the port's TogetherCodec",
    ("models/hesic_fast.py", "LANES_DEFAULT"): "the TPU lane width of the "
        "JAX constructor (ROADMAP A)",
    ("models/hesic_plus.py", "HESICPlusCodec"): "in models/"
        "hesic_plus_codec.py (exported by models)",
    ("models/hesic_plus.py", "HESICPlusTogetherCodec"): "in models/"
        "hesic_plus_codec.py (exported by models)",
    ("training/train_state.py", "TrainState"): "the optimizer holds the "
        "state (ROADMAP A)",
    ("utils/profile_fast.py", "profile_hesic_plus"): "profile_fast --model "
        "hesic-plus covers it",
}
ELSEWHERE.update({("codecs/device_rans.py", n): "a TPU link helper "
                  "(ROADMAP A)" for n in (
                      "DENSE_LINK_THRESHOLD", "pack_stream_auto",
                      "upload_words_auto", "pow2_bucket", "compact_stream",
                      "expand_stream")})
ELSEWHERE.update({("layers/conv.py", n): "a flax helper (ROADMAP A)"
                  for n in ("conv", "deconv", "pixel_shuffle",
                            "Sequential")})
JAX_MODULES = sorted(
    str(p.relative_to(ROOT / "hesic_tpu"))
    for p in (ROOT / "hesic_tpu").rglob("*.py")
    if p.name != "__init__.py" and "pallas" not in p.name)


def _names(path: pathlib.Path) -> dict:
    """A module's public top-level functions, classes (with their public
    methods, flax's ``setup`` aside) and upper-case constants."""
    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            if node.name.startswith("_"):
                continue
            out[node.name] = {
                n.name for n in getattr(node, "body", [])
                if isinstance(node, ast.ClassDef)
                and isinstance(n, ast.FunctionDef)
                and not n.name.startswith("_") and n.name != "setup"}
        elif isinstance(node, ast.Assign):
            out.update({t.id: set() for t in node.targets
                        if isinstance(t, ast.Name) and t.id.isupper()
                        and not t.id.startswith("_")})
    return out


@pytest.mark.parametrize("module", JAX_MODULES)
def test_module_public_names(module):
    """Each JAX module's public names and methods are in the port's module
    of the same name, but for ELSEWHERE (each with its reason)."""
    port = RENAMED.get(module, module)
    mod = importlib.import_module(
        "hesic_tpu_torch." + port[:-3].replace("/", "."))
    missing = []
    for name, methods in _names(ROOT / "hesic_tpu" / module).items():
        if (module, name) in ELSEWHERE:
            continue
        if not hasattr(mod, name):
            missing.append(name)
            continue
        missing += [f"{name}.{m}" for m in sorted(methods)
                    if (module, f"{name}.{m}") not in ELSEWHERE
                    and not hasattr(getattr(mod, name), m)]
    assert not missing, f"hesic_tpu_torch/{port} lacks {missing}"
