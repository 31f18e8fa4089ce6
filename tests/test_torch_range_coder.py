"""Port: the host coders that hesic_tpu_torch/codecs exports beside the
z coder (host_rans.py over its own copy of rans.cpp) against the JAX
package's (hesic_tpu/codecs), on the CPU.  Every comparison is exact:
the coders are integer code.

* ``RangeEncoder``/``RangeDecoder``: byte-identical to JAX's for one CDF,
  for per-symbol rows (``encode_rows``), for several calls into one
  stream and through a file path; each side decodes the other's stream.
* ``RangeEncoder.close`` on a body above 64 KiB: the port's bytes decode
  (the JAX binding's retried flush returns an empty body there).
* The row rANS coders (``rans_encode_with_rows``/``_decode_with_rows``)
  are byte-identical to JAX's and decode both ways.
* ``RansEncoder``, ``BufferedRansEncoder`` (one table and mixed tables)
  and ``pmf_to_quantized_cdf`` equal JAX's.
* A symbol outside its CDF raises ValueError in every encoder.
* The host library is built with the JAX package's flags
  (-ffp-contract=off) and keyed on the host (test_torch_host_ar.py's
  guard); the range coder's symbols exist in it.
"""

import os

import numpy as np
import pytest

from hesic_tpu import codecs as jcodecs
from hesic_tpu_torch import codecs
from hesic_tpu_torch.codecs import build


def _cdf(rng, n, total=65536):
    """A random CDF of n symbols over `total`, no zero bins."""
    cuts = np.sort(rng.choice(np.arange(1, total), n - 1, replace=False))
    return np.concatenate([[0], cuts, [total]]).astype(np.int32)


def _rows(rng, n, s, total=65536):
    return np.stack([_cdf(rng, s, total) for _ in range(n)])


def _one_cdf_case(seed=0):
    rng = np.random.RandomState(seed)
    cdf = _cdf(rng, 17, total=4099)       # a total that is no power of 2
    return rng.randint(0, 17, 3000).astype(np.int32), cdf


def _rows_case(seed=1):
    rng = np.random.RandomState(seed)
    rows = _rows(rng, 2000, 9)
    return rng.randint(0, 9, 2000).astype(np.int32), rows


def _encode(mod, calls, path=None):
    enc = mod.RangeEncoder(path) if path else mod.RangeEncoder()
    for kind, sym, table in calls:
        getattr(enc, kind)(sym, table)
    return enc.close()


def _calls():
    sym1, cdf = _one_cdf_case()
    sym2, rows = _rows_case()
    return [("encode", sym1[:1000], cdf), ("encode_rows", sym2, rows),
            ("encode", sym1[1000:], cdf)]


@pytest.mark.parametrize("case", ["one cdf", "rows", "several calls"])
def test_range_coder_byte_identical_to_jax(case):
    calls = _calls()
    calls = {"one cdf": calls[:1], "rows": calls[1:2],
             "several calls": calls}[case]
    got = _encode(codecs, calls)
    assert got == _encode(jcodecs, calls)
    for mod, data in ((codecs, _encode(jcodecs, calls)), (jcodecs, got)):
        dec = mod.RangeDecoder(data)
        for kind, sym, table in calls:
            out = (dec.decode(sym.size, table) if kind == "encode"
                   else dec.decode_rows(table))
            np.testing.assert_array_equal(out, sym)


def test_range_coder_through_a_file(tmp_path):
    calls = _calls()
    t_path, j_path = str(tmp_path / "t.bin"), str(tmp_path / "j.bin")
    got = _encode(codecs, calls, t_path)
    assert got == _encode(jcodecs, calls, j_path)
    with open(t_path, "rb") as f:
        assert f.read() == got
    dec = codecs.RangeDecoder(j_path)
    np.testing.assert_array_equal(dec.decode(1000, calls[0][2]),
                                  calls[0][1])
    np.testing.assert_array_equal(dec.decode_rows(calls[1][2]), calls[1][1])


def test_range_coder_body_above_64_kib():
    """100000 symbols of two bytes each: one flush, every symbol back."""
    rng = np.random.RandomState(2)
    cdf = np.array([0, 1, 2, 65536], np.int32)
    sym = rng.randint(0, 2, 100000).astype(np.int32)
    data = _encode(codecs, [("encode", sym, cdf)])
    assert len(data) > 1 << 16
    np.testing.assert_array_equal(
        codecs.RangeDecoder(data).decode(sym.size, cdf), sym)
    assert _encode(jcodecs, [("encode", sym, cdf)]) == b""


def test_row_rans_byte_identical_to_jax():
    sym, rows = _rows_case(3)
    got = codecs.rans_encode_with_rows(sym, rows)
    want = jcodecs.rans_encode_with_rows(sym, rows)
    assert got == want
    np.testing.assert_array_equal(
        codecs.rans_decode_with_rows(want, sym.size, rows), sym)
    np.testing.assert_array_equal(
        jcodecs.rans_decode_with_rows(got, sym.size, rows), sym)


def _gaussian_like_tables(seed):
    rng = np.random.RandomState(seed)
    lengths = rng.randint(3, 12, 6).astype(np.int32)
    cdfs = [codecs.pmf_to_quantized_cdf(rng.dirichlet(np.ones(n)))
            for n in lengths]
    sizes = np.array([len(c) for c in cdfs], np.int32)
    offsets = -(lengths // 2)
    return cdfs, sizes, offsets, lengths


def _symbols(rng, lengths, offsets, n):
    idx = rng.randint(0, len(lengths), n).astype(np.int32)
    # mostly inside the table, some escapes beyond either end
    sym = rng.randint(-3, lengths[idx] + 3) + offsets[idx]
    return sym.astype(np.int32), idx


def test_pmf_to_quantized_cdf_equals_jax():
    rng = np.random.RandomState(4)
    for n in (2, 7, 64):
        pmf = rng.dirichlet(np.ones(n)).astype(np.float32) * 0.999
        np.testing.assert_array_equal(codecs.pmf_to_quantized_cdf(pmf),
                                      jcodecs.pmf_to_quantized_cdf(pmf))


def test_rans_encoder_equals_jax():
    cdfs, sizes, offsets, lengths = _gaussian_like_tables(5)
    sym, idx = _symbols(np.random.RandomState(5), lengths, offsets, 500)
    got = codecs.RansEncoder().encode_with_indexes(sym, idx, cdfs, sizes,
                                                   offsets)
    assert got == jcodecs.RansEncoder().encode_with_indexes(
        sym, idx, cdfs, sizes, offsets)
    np.testing.assert_array_equal(
        jcodecs.RansDecoder().decode_with_indexes(got, idx, cdfs, sizes,
                                                  offsets), sym)


@pytest.mark.parametrize("mixed", [False, True], ids=["one table",
                                                      "mixed tables"])
def test_buffered_rans_flush_equals_jax(mixed):
    rng = np.random.RandomState(6)
    tables = [_gaussian_like_tables(7)]
    tables.append(_gaussian_like_tables(8) if mixed else tables[0])
    encs = [codecs.BufferedRansEncoder(), jcodecs.BufferedRansEncoder()]
    for i in range(4):
        cdfs, sizes, offsets, lengths = tables[i % 2]
        sym, idx = _symbols(rng, lengths, offsets, 100 + 37 * i)
        for enc in encs:
            enc.encode_with_indexes(sym, idx, cdfs, sizes, offsets)
    got, want = encs[0].flush(), encs[1].flush()
    assert got == want and len(got) > 0
    assert encs[0].flush() == b""            # the buffer was emptied


def test_out_of_range_symbol_raises():
    sym, cdf = _one_cdf_case()
    bad = sym.copy()
    bad[10] = 17                               # one past the last symbol
    with pytest.raises(ValueError):
        codecs.RangeEncoder().encode(bad, cdf)
    with pytest.raises(ValueError):
        codecs.RangeEncoder().encode(-bad, cdf)
    sym_r, rows = _rows_case()
    bad_r = sym_r.copy()
    bad_r[0] = rows.shape[1] - 1
    with pytest.raises(ValueError):
        codecs.RangeEncoder().encode_rows(bad_r, rows)
    with pytest.raises(ValueError):
        codecs.rans_encode_with_rows(bad_r, rows)
    cdfs, sizes, offsets, _ = _gaussian_like_tables(9)
    with pytest.raises(ValueError):            # an index beyond the table
        codecs.RansEncoder().encode_with_indexes(
            np.zeros(4, np.int32), np.array([0, 1, 2, 6], np.int32), cdfs,
            sizes, offsets)


def test_host_library_flags_and_symbols():
    """The JAX package's flags (no FMA contraction), the host-keyed file
    name, and the range coder's entry points in the built library."""
    assert "-ffp-contract=off" in build._HOST_FLAGS
    assert build._HOST_ARCH == ["-march=native"]
    path = build.build("rans")
    tag = build.host_tag()
    assert os.path.basename(path) == f"librans-{tag}.so"
    lib = build.load("rans")
    for name in ("hesic_rc_encoder_new", "hesic_rc_encode_rows",
                 "hesic_rc_encoder_flush", "hesic_rc_decode_rows",
                 "hesic_rans_encode_with_rows",
                 "hesic_rans_decode_with_rows"):
        assert hasattr(lib, name), name
