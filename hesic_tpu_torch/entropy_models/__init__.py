"""Entropy models (training forward and likelihoods) and host-side coder
tables."""

from .codec import (CdfTables, compress_with_indexes, decode_streams_batch,
                    decompress_with_indexes, tables_from_pmf)
from .entropy_models import (EntropyBottleneck, GaussianConditional,
                             GaussianMixtureConditional,
                             standardized_cumulative)

__all__ = ["CdfTables", "EntropyBottleneck", "GaussianConditional",
           "GaussianMixtureConditional",
           "compress_with_indexes", "decode_streams_batch",
           "decompress_with_indexes", "standardized_cumulative",
           "tables_from_pmf"]
