"""Host-side coder state: quantized CDF tables + (de)compress helpers,
as hesic_tpu/entropy_models/codec.py, over the port's own host rANS coder
(codecs/host_rans.py)."""

from __future__ import annotations

import dataclasses

import numpy as np

from ..codecs import host_rans


@dataclasses.dataclass
class CdfTables:
    """Quantized CDF table set for one entropy model."""

    quantized_cdf: np.ndarray  # (num_cdfs, max_len + 2) int32
    cdf_length: np.ndarray     # (num_cdfs,) int32
    offset: np.ndarray         # (num_cdfs,) int32


def tables_from_pmf(pmf, tail_mass, pmf_length, offset,
                    precision: int = 16) -> CdfTables:
    """Quantize a padded PMF table into integer CDFs (one native call)."""
    pmf_length = np.asarray(pmf_length, np.int32)
    cdf = host_rans.pmf_to_quantized_cdf_batch(
        np.asarray(pmf, np.float32), pmf_length,
        np.asarray(tail_mass, np.float32), precision)
    return CdfTables(cdf, pmf_length + 2, np.asarray(offset, np.int32))


def compress_with_indexes(symbols: np.ndarray, indexes: np.ndarray,
                          tables: CdfTables) -> list:
    """Encode a batched symbol tensor; one string per leading-dim item.
    Every item shares the index pattern of ``indexes[0]``."""
    symbols = np.asarray(symbols)
    indexes = np.asarray(indexes)
    if symbols.shape != indexes.shape:
        raise ValueError("`symbols` and `indexes` must have the same shape")
    b = symbols.shape[0]
    return host_rans.rans_encode_batch(
        symbols.reshape(b, -1), indexes[0].reshape(-1),
        tables.quantized_cdf, tables.cdf_length, tables.offset)


def decode_streams_batch(data: bytes, begins, ends, indexes_1d,
                         tables: CdfTables) -> np.ndarray:
    """Decode n independent streams at [begins[i], ends[i]) inside `data`
    in one native call; each yields ``indexes_1d.size`` symbols."""
    indexes_1d = np.asarray(indexes_1d).reshape(-1)
    return host_rans.rans_decode_batch(
        data, begins, ends, indexes_1d, indexes_1d.size,
        tables.quantized_cdf, tables.cdf_length, tables.offset)


def decompress_with_indexes(strings: list, indexes: np.ndarray,
                            tables: CdfTables) -> np.ndarray:
    """Decode strings back to the symbol tensor shaped like `indexes`
    (every item sharing the index pattern of ``indexes[0]``)."""
    indexes = np.asarray(indexes)
    if len(strings) != indexes.shape[0]:
        raise ValueError("one string per batch item expected")
    data = b"".join(strings)
    ends = np.cumsum([len(s) for s in strings], dtype=np.int64)
    begins = np.concatenate([[0], ends[:-1]]).astype(np.int64)
    return decode_streams_batch(data, begins, ends, indexes[0],
                                tables).reshape(indexes.shape)
