"""Entropy models and host-side coder tables."""

from .codec import (CdfTables, compress_with_indexes, decode_streams_batch,
                    decompress_with_indexes, tables_from_pmf)
from .entropy_models import EntropyBottleneck

__all__ = ["CdfTables", "EntropyBottleneck", "compress_with_indexes",
           "decode_streams_batch", "decompress_with_indexes",
           "tables_from_pmf"]
