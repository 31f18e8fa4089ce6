"""ctypes bindings for the host rANS coder (csrc/rans.cpp).

Array-oriented: every call takes numpy arrays and crosses the Python/C++
boundary once per tensor.  The library is built and loaded on first use
(codecs/build.py), never at import.
"""

from __future__ import annotations

import ctypes

import numpy as np

from . import build

_c_i32p = ctypes.POINTER(ctypes.c_int32)
_c_i64p = ctypes.POINTER(ctypes.c_int64)
_c_f32p = ctypes.POINTER(ctypes.c_float)
_c_u8p = ctypes.POINTER(ctypes.c_uint8)

_SIGNATURES = {
    "hesic_pmf_to_quantized_cdf_batch": (ctypes.c_int, [
        _c_f32p, _c_i32p, _c_f32p, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, _c_i32p]),
    "hesic_rans_encode_batch": (ctypes.c_int64, [
        _c_i32p, _c_i32p, ctypes.c_int64, ctypes.c_int32, _c_i32p,
        ctypes.c_int32, _c_i32p, _c_i32p, ctypes.c_int32, _c_u8p,
        ctypes.c_int64, _c_i64p]),
    "hesic_rans_decode_batch": (ctypes.c_int64, [
        _c_u8p, _c_i64p, _c_i64p, _c_i32p, ctypes.c_int64,
        ctypes.c_int32, _c_i32p, ctypes.c_int32, _c_i32p, _c_i32p,
        ctypes.c_int32, _c_i32p]),
}


def _lib() -> ctypes.CDLL:
    lib = build.load("rans")
    if not getattr(lib, "_hesic_typed", False):
        for fn, (restype, argtypes) in _SIGNATURES.items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        lib._hesic_typed = True
    return lib


def _i32(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a).reshape(-1), dtype=np.int32)


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctype)


def pmf_to_quantized_cdf_batch(pmfs, pmf_lengths, tail_mass,
                               precision: int = 16) -> np.ndarray:
    """Quantize a padded (num, max_len) PMF table in one native call.

    Returns an int32 (num, max_len + 2) table; row i holds a CDF of
    pmf_lengths[i] + 2 entries (the extra bin is the tail mass), zero
    padded."""
    p = np.ascontiguousarray(np.asarray(pmfs), dtype=np.float32)
    if p.ndim != 2:
        raise ValueError("pmfs must be 2-D (num, max_len)")
    num, max_len = p.shape
    lengths = _i32(pmf_lengths)
    tails = np.ascontiguousarray(np.asarray(tail_mass).reshape(-1),
                                 dtype=np.float32)
    if lengths.size != num or tails.size != num:
        raise ValueError("pmf_lengths/tail_mass must have `num` entries")
    out = np.empty((num, max_len + 2), dtype=np.int32)
    rc = _lib().hesic_pmf_to_quantized_cdf_batch(
        _ptr(p, _c_f32p), _ptr(lengths, _c_i32p), _ptr(tails, _c_f32p),
        num, max_len, precision, _ptr(out, _c_i32p))
    if rc != 0:
        raise ValueError(f"pmf_to_quantized_cdf_batch failed (rc={rc})")
    return out


def rans_encode_batch(symbols, indexes, cdfs, cdf_sizes,
                      offsets) -> list:
    """Encode (n_streams, n_per) symbols as n_streams independent rANS
    streams sharing one CDF table and one (n_per,) index vector."""
    sym = np.ascontiguousarray(np.asarray(symbols), dtype=np.int32)
    if sym.ndim != 2:
        raise ValueError("symbols must be (n_streams, n_per)")
    n_streams, n_per = sym.shape
    idx = _i32(indexes)
    if idx.size != n_per:
        raise ValueError("indexes must have n_per entries")
    table = np.ascontiguousarray(cdfs, dtype=np.int32)
    sizes = _i32(cdf_sizes)
    offs = _i32(offsets)
    cap = max(1 << 12, n_per * 12 + 64)
    while True:
        out = np.empty((n_streams, cap), dtype=np.uint8)
        lens = np.empty(n_streams, dtype=np.int64)
        rc = _lib().hesic_rans_encode_batch(
            _ptr(sym, _c_i32p), _ptr(idx, _c_i32p), n_per, n_streams,
            _ptr(table, _c_i32p), table.shape[1], _ptr(sizes, _c_i32p),
            _ptr(offs, _c_i32p), table.shape[0], _ptr(out, _c_u8p), cap,
            _ptr(lens, _c_i64p))
        if rc == 0:
            return [out[s, : lens[s]].tobytes() for s in range(n_streams)]
        if rc == -1:
            raise ValueError("encode failed: index out of range")
        if rc == -3:
            raise ValueError("encode failed: invalid CDF table")
        cap = int(-rc)


def rans_decode_batch(data: bytes, begins, ends, indexes, n_per: int,
                      cdfs, cdf_sizes, offsets) -> np.ndarray:
    """Decode the streams at byte extents [begins[s], ends[s]) of `data`
    in one native call.  Returns (n_streams, n_per) int32 symbols."""
    buf = np.frombuffer(data, dtype=np.uint8)
    b = np.ascontiguousarray(np.asarray(begins), dtype=np.int64)
    e = np.ascontiguousarray(np.asarray(ends), dtype=np.int64)
    if b.shape != e.shape or b.ndim != 1:
        raise ValueError("begins/ends must be matching 1-D arrays")
    idx = _i32(indexes)
    if idx.size != n_per:
        raise ValueError("indexes must have n_per entries")
    table = np.ascontiguousarray(cdfs, dtype=np.int32)
    sizes = _i32(cdf_sizes)
    offs = _i32(offsets)
    out = np.empty((b.size, n_per), dtype=np.int32)
    n = _lib().hesic_rans_decode_batch(
        _ptr(buf, _c_u8p), _ptr(b, _c_i64p), _ptr(e, _c_i64p),
        _ptr(idx, _c_i32p), n_per, b.size, _ptr(table, _c_i32p),
        table.shape[1], _ptr(sizes, _c_i32p), _ptr(offs, _c_i32p),
        table.shape[0], _ptr(out, _c_i32p))
    if n != b.size * n_per:
        raise ValueError("batched rANS decode failed")
    return out
