"""Entropy models (training forward and likelihoods) and host-side coder
tables; exports the JAX package's names (and ``decode_streams_batch``,
the port's batched z decoder)."""

from .codec import (CdfTables, compress_with_indexes, decode_streams_batch,
                    decompress_with_indexes, gaussian_tables,
                    tables_from_pmf)
from .entropy_models import (SCALES_LEVELS, SCALES_MAX, SCALES_MIN,
                             EntropyBottleneck, GaussianConditional,
                             GaussianMixtureConditional, build_indexes,
                             gaussian_pmf_data, get_scale_table, gmm_pmf,
                             gmm_pmf_edges, standardized_cumulative,
                             standardized_quantile)

__all__ = ["CdfTables", "EntropyBottleneck", "GaussianConditional",
           "GaussianMixtureConditional", "SCALES_LEVELS", "SCALES_MAX",
           "SCALES_MIN", "build_indexes", "compress_with_indexes",
           "decode_streams_batch", "decompress_with_indexes",
           "gaussian_pmf_data", "gaussian_tables", "get_scale_table",
           "gmm_pmf", "gmm_pmf_edges", "standardized_cumulative",
           "standardized_quantile", "tables_from_pmf"]
