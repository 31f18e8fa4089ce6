"""Host-side coder state: quantized CDF tables (the EntropyBottleneck's
from its PMFs, the GaussianConditional's over a scale table) and the
(de)compress helpers, as hesic_tpu/entropy_models/codec.py, over the
port's own host rANS coder (codecs/host_rans.py)."""

from __future__ import annotations

import dataclasses

import numpy as np

from ..codecs import host_rans
from .entropy_models import gaussian_pmf_data


@dataclasses.dataclass
class CdfTables:
    """Quantized CDF table set for one entropy model."""

    quantized_cdf: np.ndarray  # (num_cdfs, max_len + 2) int32
    cdf_length: np.ndarray     # (num_cdfs,) int32
    offset: np.ndarray         # (num_cdfs,) int32

    @property
    def num_cdfs(self) -> int:
        return self.quantized_cdf.shape[0]

    def state_dict(self) -> dict:
        return {"quantized_cdf": self.quantized_cdf,
                "cdf_length": self.cdf_length, "offset": self.offset}

    @classmethod
    def from_state_dict(cls, d: dict) -> "CdfTables":
        return cls(np.asarray(d["quantized_cdf"], np.int32),
                   np.asarray(d["cdf_length"], np.int32),
                   np.asarray(d["offset"], np.int32))


def tables_from_pmf(pmf, tail_mass, pmf_length, offset,
                    precision: int = 16) -> CdfTables:
    """Quantize a padded PMF table into integer CDFs (one native call)."""
    pmf_length = np.asarray(pmf_length, np.int32)
    cdf = host_rans.pmf_to_quantized_cdf_batch(
        np.asarray(pmf, np.float32), pmf_length,
        np.asarray(tail_mass, np.float32), precision)
    return CdfTables(cdf, pmf_length + 2, np.asarray(offset, np.int32))


def gaussian_tables(scale_table, tail_mass: float = 1e-9) -> CdfTables:
    """The GaussianConditional's tables over a scale table."""
    return tables_from_pmf(*gaussian_pmf_data(scale_table, tail_mass))


def _shared(indexes: np.ndarray) -> bool:
    """Whether every batch item shares the index pattern of item 0 (a
    broadcast array, or a batch of one)."""
    return indexes.shape[0] == 1 or indexes.strides[0] == 0


def compress_with_indexes(symbols: np.ndarray, indexes: np.ndarray,
                          tables: CdfTables) -> list:
    """Encode a batched symbol tensor; one string per leading-dim item.
    Items that share one index pattern (a broadcast index array) are
    coded in one native call, others one stream at a time."""
    symbols = np.asarray(symbols)
    indexes = np.asarray(indexes)
    if symbols.shape != indexes.shape:
        raise ValueError("`symbols` and `indexes` must have the same shape")
    b = symbols.shape[0]
    if _shared(indexes):
        return host_rans.rans_encode_batch(
            symbols.reshape(b, -1), indexes[0].reshape(-1),
            tables.quantized_cdf, tables.cdf_length, tables.offset)
    return [host_rans.encode_with_indexes(
        symbols[i], indexes[i], tables.quantized_cdf, tables.cdf_length,
        tables.offset) for i in range(b)]


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
    """Decode strings back to the symbol tensor shaped like `indexes`."""
    indexes = np.asarray(indexes)
    if len(strings) != indexes.shape[0]:
        raise ValueError("one string per batch item expected")
    if not _shared(indexes):
        return np.stack([host_rans.decode_with_indexes(
            s, indexes[i], tables.quantized_cdf, tables.cdf_length,
            tables.offset).reshape(indexes.shape[1:])
            for i, s in enumerate(strings)])
    data = b"".join(strings)
    ends = np.cumsum([len(s) for s in strings], dtype=np.int64)
    begins = np.concatenate([[0], ends[:-1]]).astype(np.int64)
    return decode_streams_batch(data, begins, ends, indexes[0],
                                tables).reshape(indexes.shape)
