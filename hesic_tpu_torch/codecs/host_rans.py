"""ctypes bindings for the host coders (csrc/rans.cpp).

Array-oriented: every call takes numpy arrays and crosses the Python/C++
boundary once per tensor.  The library is built and loaded on first use
(codecs/build.py), never at import.  It is loaded with ``ctypes.CDLL``,
which releases the GIL for the length of every native call, so the host
AR codecs' threads code a batch's images in parallel.

Beyond the batched z coder and the CDF quantizer: the single-stream
``encode_with_indexes``/``decode_with_indexes`` (and the classes over
them, ``RansEncoder`` and ``BufferedRansEncoder``), the stateful
``RansDecoder`` (``set_stream``/``decode_stream``, the numpy AR
decoder's coder), the row rANS coders (``rans_encode_with_rows``/
``rans_decode_with_rows``: one CDF row per symbol, no escapes), the
range coder of the reference-layout container codecs (``RangeEncoder``/
``RangeDecoder``: arbitrary CDF totals, one row per symbol or one CDF
for many) and the raster-causal AR coder (``ArWeightsNative``,
``ar_code``), as hesic_tpu/codecs/rans.py binds them.

One divergence from that module: ``RangeEncoder.close`` sizes its
buffer from the symbols encoded (an encode shifts out at most 3 bytes,
since it leaves the range at least 1 and renormalizes below 2^24; the
flush 5) and flushes once.  The
JAX binding retries a flush that overflows its first 64 KiB buffer, and
the native flush then runs twice, so a longer body comes back empty.
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
    "hesic_rans_encode_with_indexes": (ctypes.c_int64, [
        _c_i32p, _c_i32p, ctypes.c_int64, _c_i32p, ctypes.c_int32, _c_i32p,
        _c_i32p, ctypes.c_int32, _c_u8p, ctypes.c_int64]),
    "hesic_rans_decode_with_indexes": (ctypes.c_int64, [
        _c_u8p, ctypes.c_int64, _c_i32p, ctypes.c_int64, _c_i32p,
        ctypes.c_int32, _c_i32p, _c_i32p, ctypes.c_int32, _c_i32p]),
    "hesic_rans_decoder_new": (ctypes.c_void_p, [_c_u8p, ctypes.c_int64]),
    "hesic_rans_decoder_free": (None, [ctypes.c_void_p]),
    "hesic_rans_decoder_decode": (ctypes.c_int64, [
        ctypes.c_void_p, _c_i32p, ctypes.c_int64, _c_i32p, ctypes.c_int32,
        _c_i32p, _c_i32p, ctypes.c_int32, _c_i32p]),
    "hesic_pmf_to_quantized_cdf": (ctypes.c_int, [
        _c_f32p, ctypes.c_int32, ctypes.c_int32, _c_i32p]),
    "hesic_rans_encode_with_rows": (ctypes.c_int64, [
        _c_i32p, ctypes.c_int64, _c_i32p, ctypes.c_int32, _c_u8p,
        ctypes.c_int64]),
    "hesic_rans_decode_with_rows": (ctypes.c_int64, [
        _c_u8p, ctypes.c_int64, ctypes.c_int64, _c_i32p, ctypes.c_int32,
        _c_i32p]),
    "hesic_rc_encoder_new": (ctypes.c_void_p, []),
    "hesic_rc_encoder_free": (None, [ctypes.c_void_p]),
    "hesic_rc_encode": (ctypes.c_int, [
        ctypes.c_void_p, _c_i32p, ctypes.c_int64, _c_i32p, ctypes.c_int32]),
    "hesic_rc_encode_rows": (ctypes.c_int, [
        ctypes.c_void_p, _c_i32p, ctypes.c_int64, _c_i32p, ctypes.c_int32]),
    "hesic_rc_encoder_flush": (ctypes.c_int64, [
        ctypes.c_void_p, _c_u8p, ctypes.c_int64]),
    "hesic_rc_decoder_new": (ctypes.c_void_p, [_c_u8p, ctypes.c_int64]),
    "hesic_rc_decoder_free": (None, [ctypes.c_void_p]),
    "hesic_rc_decode": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_int64, _c_i32p, ctypes.c_int32, _c_i32p]),
    "hesic_rc_decode_rows": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_int64, _c_i32p, ctypes.c_int32, _c_i32p]),
    "hesic_ar_code": (ctypes.c_int64, [
        ctypes.c_int, _c_f32p, _c_f32p, _c_u8p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        _c_f32p, _c_f32p, _c_f32p, _c_f32p, _c_f32p, _c_f32p,
        _c_f32p, _c_f32p, ctypes.c_int, _c_f32p, _c_f32p, ctypes.c_int,
        _c_f32p, _c_f32p, _c_f32p, ctypes.c_int,
        _c_i32p, ctypes.c_int32, _c_i32p, _c_i32p, ctypes.c_int32]),
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


def _as_cdf_table(cdfs) -> np.ndarray:
    """A 2-D int array, or a ragged list of rows zero-padded to one, as a
    contiguous int32 table."""
    if isinstance(cdfs, np.ndarray) and cdfs.ndim == 2:
        return np.ascontiguousarray(cdfs, dtype=np.int32)
    rows = [np.asarray(r, dtype=np.int32) for r in cdfs]
    out = np.zeros((len(rows), max(len(r) for r in rows)), dtype=np.int32)
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
    return out


def _rows(cdf_rows, n: int) -> np.ndarray:
    """(n, row_len) int32 CDF rows, one per symbol."""
    rows = np.ascontiguousarray(np.asarray(cdf_rows), dtype=np.int32)
    if rows.ndim != 2 or rows.shape[0] != n:
        raise ValueError("cdf_rows must be (n_symbols, row_len)")
    return rows


def pmf_to_quantized_cdf(pmf, precision: int = 16) -> np.ndarray:
    """Float PMF -> integer CDF of pmf.size + 1 entries summing to
    2**precision, no zero bins."""
    p = np.ascontiguousarray(np.asarray(pmf).reshape(-1), dtype=np.float32)
    out = np.empty(p.size + 1, dtype=np.int32)
    rc = _lib().hesic_pmf_to_quantized_cdf(_ptr(p, _c_f32p), p.size,
                                           precision, _ptr(out, _c_i32p))
    if rc != 0:
        raise ValueError(f"pmf_to_quantized_cdf failed (rc={rc})")
    return out


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


def _table(cdfs, cdf_sizes, offsets):
    return _as_cdf_table(cdfs), _i32(cdf_sizes), _i32(offsets)


def encode_with_indexes(symbols, indexes, cdfs, cdf_sizes,
                        offsets) -> bytes:
    """Encode one stream: symbols[i] with the CDF row indexes[i]."""
    sym, idx = _i32(symbols), _i32(indexes)
    if sym.size != idx.size:
        raise ValueError("symbols and indexes must have the same size")
    table, sizes, offs = _table(cdfs, cdf_sizes, offsets)
    cap = max(1 << 12, sym.size * 12 + 64)
    while True:
        out = np.empty(cap, dtype=np.uint8)
        n = _lib().hesic_rans_encode_with_indexes(
            _ptr(sym, _c_i32p), _ptr(idx, _c_i32p), sym.size,
            _ptr(table, _c_i32p), table.shape[1], _ptr(sizes, _c_i32p),
            _ptr(offs, _c_i32p), table.shape[0], _ptr(out, _c_u8p), cap)
        if n >= 0:
            return out[:n].tobytes()
        if n == -1:
            raise ValueError("encode failed: index out of range")
        if n == -3:
            raise ValueError("encode failed: invalid CDF table")
        cap = int(-n)


def decode_with_indexes(data: bytes, indexes, cdfs, cdf_sizes,
                        offsets) -> np.ndarray:
    """Decode one stream of ``indexes.size`` symbols -> int32 (n,)."""
    buf = np.frombuffer(data, dtype=np.uint8)
    idx = _i32(indexes)
    table, sizes, offs = _table(cdfs, cdf_sizes, offsets)
    out = np.empty(idx.size, dtype=np.int32)
    n = _lib().hesic_rans_decode_with_indexes(
        _ptr(buf, _c_u8p), buf.size, _ptr(idx, _c_i32p), idx.size,
        _ptr(table, _c_i32p), table.shape[1], _ptr(sizes, _c_i32p),
        _ptr(offs, _c_i32p), table.shape[0], _ptr(out, _c_i32p))
    if n != idx.size:
        raise ValueError("rANS decode failed")
    return out


class RansEncoder:
    """Stateless rANS encoder: one stream per call."""

    def encode_with_indexes(self, symbols, indexes, cdfs, cdf_sizes,
                            offsets) -> bytes:
        return encode_with_indexes(symbols, indexes, cdfs, cdf_sizes,
                                   offsets)


class BufferedRansEncoder:
    """Accumulates (symbols, indexes, table) chunks; ``flush`` codes them
    as one stream.  Chunks under one table are coded against it; chunks
    under different tables against their concatenation, each chunk's
    indexes shifted to its own rows."""

    def __init__(self):
        self._chunks: list = []

    def encode_with_indexes(self, symbols, indexes, cdfs, cdf_sizes,
                            offsets):
        self._chunks.append((_i32(symbols), _i32(indexes),
                             *_table(cdfs, cdf_sizes, offsets)))

    def flush(self) -> bytes:
        if not self._chunks:
            return b""
        chunks, self._chunks = self._chunks, []
        first = chunks[0][2]
        if all(c[2] is first or (c[2].shape == first.shape
                                 and np.array_equal(c[2], first))
               for c in chunks):
            _, _, table, sizes, offs = chunks[0]
            sym = np.concatenate([c[0] for c in chunks])
            idx = np.concatenate([c[1] for c in chunks])
        else:
            stride = max(c[2].shape[1] for c in chunks)
            tables, idxs, base = [], [], 0
            for _, i, t, _, _ in chunks:
                tables.append(np.pad(t, ((0, 0), (0, stride - t.shape[1]))))
                idxs.append(i + base)
                base += t.shape[0]
            table = np.concatenate(tables)
            sizes = np.concatenate([c[3] for c in chunks])
            offs = np.concatenate([c[4] for c in chunks])
            sym = np.concatenate([c[0] for c in chunks])
            idx = np.concatenate(idxs)
        return encode_with_indexes(sym, idx, table, sizes, offs)


def rans_encode_with_rows(symbols, cdf_rows) -> bytes:
    """Encode symbols[i] with its own CDF row cdf_rows[i] (rows of
    2**16 total, no zero bins, no escapes) as one rANS stream."""
    sym = _i32(symbols)
    rows = _rows(cdf_rows, sym.size)
    cap = max(1 << 12, sym.size * 8 + 64)
    while True:
        out = np.empty(cap, dtype=np.uint8)
        n = _lib().hesic_rans_encode_with_rows(
            _ptr(sym, _c_i32p), sym.size, _ptr(rows, _c_i32p),
            rows.shape[1], _ptr(out, _c_u8p), cap)
        if n >= 0:
            return out[:n].tobytes()
        if n == -1:
            raise ValueError("encode failed: symbol out of range")
        cap = int(-n)


def rans_decode_with_rows(encoded: bytes, n_symbols: int,
                          cdf_rows) -> np.ndarray:
    """Inverse of rans_encode_with_rows -> (n_symbols,) int32."""
    rows = _rows(cdf_rows, n_symbols)
    data = np.frombuffer(encoded, dtype=np.uint8)
    out = np.empty(n_symbols, dtype=np.int32)
    n = _lib().hesic_rans_decode_with_rows(
        _ptr(data, _c_u8p), data.size, n_symbols, _ptr(rows, _c_i32p),
        rows.shape[1], _ptr(out, _c_i32p))
    if n != n_symbols:
        raise ValueError("rANS row decode failed")
    return out


class RangeEncoder:
    """The range coder (LZMA-style carry handling, arbitrary CDF totals
    below 2^24): ``encode`` many symbols under one CDF or ``encode_rows``
    each under its own row, any number of times, then ``close`` for the
    bytes, which it also writes to `path` when one is given."""

    def __init__(self, path: str = None):
        self._handle = _lib().hesic_rc_encoder_new()
        self._path = path
        self._symbols = 0

    def __del__(self):
        self._free()

    def _free(self):
        if getattr(self, "_handle", None):
            _lib().hesic_rc_encoder_free(self._handle)
            self._handle = None

    def _check(self, rc: int, n: int):
        if rc != 0:
            raise ValueError(f"range encode failed (rc={rc}): a symbol "
                             f"outside its CDF or a zero-width bin")
        self._symbols += n

    def encode(self, symbols, cdf):
        sym, c = _i32(symbols), _i32(cdf)
        self._check(_lib().hesic_rc_encode(
            self._handle, _ptr(sym, _c_i32p), sym.size, _ptr(c, _c_i32p),
            c.size), sym.size)

    def encode_rows(self, symbols, cdf_rows):
        """Encode symbols[i] with cdf_rows[i] in one native call."""
        sym = _i32(symbols)
        rows = _rows(cdf_rows, sym.size)
        self._check(_lib().hesic_rc_encode_rows(
            self._handle, _ptr(sym, _c_i32p), sym.size,
            _ptr(rows, _c_i32p), rows.shape[1]), sym.size)

    def close(self) -> bytes:
        cap = 3 * self._symbols + 64
        out = np.empty(cap, dtype=np.uint8)
        n = _lib().hesic_rc_encoder_flush(self._handle, _ptr(out, _c_u8p),
                                          cap)
        self._free()
        if n < 0:
            raise ValueError(f"range coder output of {-n} bytes exceeds "
                             f"its bound of {cap}")
        result = out[:n].tobytes()
        if self._path is not None:
            with open(self._path, "wb") as f:
                f.write(result)
        return result


class RangeDecoder:
    """Counterpart of RangeEncoder over bytes or a file path; the native
    decoder keeps its own copy of the bytes."""

    def __init__(self, source):
        if isinstance(source, (bytes, bytearray)):
            data = bytes(source)
        else:
            with open(source, "rb") as f:
                data = f.read()
        buf = np.frombuffer(data, dtype=np.uint8)
        self._handle = _lib().hesic_rc_decoder_new(_ptr(buf, _c_u8p),
                                                   buf.size)

    def __del__(self):
        self.close()

    def close(self):
        if getattr(self, "_handle", None):
            _lib().hesic_rc_decoder_free(self._handle)
            self._handle = None

    def decode(self, n: int, cdf) -> np.ndarray:
        """n symbols under one CDF -> (n,) int32."""
        c = _i32(cdf)
        out = np.empty(n, dtype=np.int32)
        rc = _lib().hesic_rc_decode(self._handle, n, _ptr(c, _c_i32p),
                                    c.size, _ptr(out, _c_i32p))
        if rc != 0:
            raise ValueError(f"range decode failed (rc={rc})")
        return out

    def decode_rows(self, cdf_rows) -> np.ndarray:
        """One symbol per row of `cdf_rows` (n, row_len) -> (n,) int32."""
        rows = np.ascontiguousarray(np.asarray(cdf_rows), dtype=np.int32)
        if rows.ndim != 2:
            raise ValueError("cdf_rows must be (n_symbols, row_len)")
        out = np.empty(rows.shape[0], dtype=np.int32)
        rc = _lib().hesic_rc_decode_rows(
            self._handle, rows.shape[0], _ptr(rows, _c_i32p), rows.shape[1],
            _ptr(out, _c_i32p))
        if rc != 0:
            raise ValueError(f"range decode failed (rc={rc})")
        return out


class RansDecoder:
    """rANS decoder: ``decode_with_indexes`` decodes one whole stream
    (stateless); ``set_stream`` once, then ``decode_stream`` walks a
    stream a chunk of symbols at a time (the autoregressive decode
    pattern).  The native decoder keeps its own copy of the bytes."""

    def __init__(self):
        self._handle = None

    def __del__(self):
        self._close()

    def _close(self):
        if getattr(self, "_handle", None):
            _lib().hesic_rans_decoder_free(self._handle)
            self._handle = None

    def decode_with_indexes(self, encoded: bytes, indexes, cdfs, cdf_sizes,
                            offsets) -> np.ndarray:
        """Decode one whole stream of ``indexes.size`` symbols -> int32
        (n,) (module-level decode_with_indexes)."""
        return decode_with_indexes(encoded, indexes, cdfs, cdf_sizes,
                                   offsets)

    def set_stream(self, encoded: bytes):
        self._close()
        data = np.frombuffer(encoded, dtype=np.uint8)
        self._handle = _lib().hesic_rans_decoder_new(_ptr(data, _c_u8p),
                                                     data.size)
        if not self._handle:
            raise ValueError("invalid rANS stream")

    def decode_stream(self, indexes, cdfs, cdf_sizes,
                      offsets) -> np.ndarray:
        if not self._handle:
            raise ValueError("set_stream() first")
        idx = _i32(indexes)
        table, sizes, offs = _table(cdfs, cdf_sizes, offsets)
        out = np.empty(idx.size, dtype=np.int32)
        n = _lib().hesic_rans_decoder_decode(
            self._handle, _ptr(idx, _c_i32p), idx.size,
            _ptr(table, _c_i32p), table.shape[1], _ptr(sizes, _c_i32p),
            _ptr(offs, _c_i32p), table.shape[0], _ptr(out, _c_i32p))
        if n != idx.size:
            raise ValueError("rANS decode_stream failed")
        return out


def _f32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float32)


class ArWeightsNative:
    """The AR coder's weights as contiguous float32 host arrays: the
    masked context kernel's two upper rows as one (10M, 2M) matrix and
    its two left taps (M, 2M) each, the entropy-parameter kernels (in,
    out) and biases, and the scale table's thresholds (all but its last
    entry)."""

    def __init__(self, ctx_kernel, ctx_bias, ep_kernels, ep_biases,
                 scale_table):
        ck = np.asarray(ctx_kernel, np.float32)  # (5, 5, M, 2M), masked
        self.m = ck.shape[2]
        self.k_up = _f32(ck[:2].reshape(2 * 5 * self.m, 2 * self.m))
        self.k_left2 = _f32(ck[2, 0])
        self.k_left1 = _f32(ck[2, 1])
        self.ctx_bias = _f32(ctx_bias)
        self.ep_w = [_f32(w) for w in ep_kernels]
        self.ep_b = [_f32(b) for b in ep_biases]
        self.thresholds = _f32(np.asarray(scale_table)[:-1])


def ar_code(direction: int, weights: ArWeightsNative, pre, post, tables,
            y=None, stream: bytes = None):
    """Run the raster-causal coder (0 = encode, 1 = decode) natively.

    pre: (h, w, P) float32; post: (h, w, Q) float32 or None; tables: the
    Gaussian conditional's CdfTables.  Encode: y (h, w, M) -> (stream
    bytes, y_hat (h, w, M)); decode: stream -> y_hat.  Both directions
    run one float implementation, so their Gaussian parameters are
    bit-identical."""
    pre = _f32(pre)
    h, w, p_dim = pre.shape
    m = weights.m
    post_arr = None if post is None else _f32(post)
    q_dim = 0 if post_arr is None else post_arr.shape[-1]
    y_hat = np.empty((h, w, m), np.float32)
    cdf, sizes, offs = _table(tables.quantized_cdf, tables.cdf_length,
                              tables.offset)
    wt = weights

    def call(direction, y_ptr, buf, n):
        return _lib().hesic_ar_code(
            direction, y_ptr, _ptr(y_hat, _c_f32p), _ptr(buf, _c_u8p), n,
            h, w, m, p_dim, q_dim, _ptr(pre, _c_f32p),
            _ptr(post_arr, _c_f32p) if q_dim else None,
            _ptr(wt.k_up, _c_f32p), _ptr(wt.k_left2, _c_f32p),
            _ptr(wt.k_left1, _c_f32p), _ptr(wt.ctx_bias, _c_f32p),
            _ptr(wt.ep_w[0], _c_f32p), _ptr(wt.ep_b[0], _c_f32p),
            wt.ep_w[0].shape[1], _ptr(wt.ep_w[1], _c_f32p),
            _ptr(wt.ep_b[1], _c_f32p), wt.ep_w[1].shape[1],
            _ptr(wt.ep_w[2], _c_f32p), _ptr(wt.ep_b[2], _c_f32p),
            _ptr(wt.thresholds, _c_f32p), wt.thresholds.size,
            _ptr(cdf, _c_i32p), cdf.shape[1], _ptr(sizes, _c_i32p),
            _ptr(offs, _c_i32p), cdf.shape[0])

    if direction == 0:
        y_arr = _f32(y)
        if y_arr.shape != (h, w, m):
            raise ValueError(f"y must be {(h, w, m)}, got {y_arr.shape}")
        cap = h * w * m * 12 + 1024
        while True:
            out = np.empty(cap, np.uint8)
            n = call(0, _ptr(y_arr, _c_f32p), out, cap)
            if n >= 0:
                return out[:n].tobytes(), y_hat
            if n == -2:
                raise ValueError("ar encode failed: scale index outside "
                                 "the tables")
            cap = int(-n)
    data = np.frombuffer(stream, np.uint8)
    rc = call(1, None, data, data.size)
    if rc != 0:
        raise ValueError(f"ar decode failed (rc={rc})")
    return y_hat
