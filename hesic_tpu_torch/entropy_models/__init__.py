"""Entropy models (training forward and likelihoods) and host-side coder
tables."""

from .codec import (CdfTables, compress_with_indexes, decode_streams_batch,
                    decompress_with_indexes, gaussian_tables,
                    tables_from_pmf)
from .entropy_models import (EntropyBottleneck, GaussianConditional,
                             GaussianMixtureConditional, build_indexes,
                             gaussian_pmf_data, get_scale_table, gmm_pmf,
                             standardized_cumulative)

__all__ = ["CdfTables", "EntropyBottleneck", "GaussianConditional",
           "GaussianMixtureConditional", "build_indexes",
           "compress_with_indexes", "decode_streams_batch",
           "decompress_with_indexes", "gaussian_pmf_data",
           "gaussian_tables", "get_scale_table", "gmm_pmf",
           "standardized_cumulative", "tables_from_pmf"]
