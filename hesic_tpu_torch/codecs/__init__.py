"""Entropy coding: the host coders (rANS for z and the AR families, the
range coder of the reference-layout containers), deterministic float
math, the three CUDA kernels of the fast codec and the slot-stream
encoder of the wavefront codec, each with its plain twin (the
wavefront's level-scan kernel is in models/wavefront.py; all sources
are under csrc/).  The host coders' public names are the JAX package's
(hesic_tpu/codecs/__init__.py)."""

from .host_rans import (BufferedRansEncoder, RangeDecoder, RangeEncoder,
                        RansDecoder, RansEncoder, pmf_to_quantized_cdf,
                        pmf_to_quantized_cdf_batch, rans_decode_batch,
                        rans_decode_with_rows, rans_encode_batch,
                        rans_encode_with_rows)

__all__ = [
    "BufferedRansEncoder",
    "RangeDecoder",
    "RangeEncoder",
    "RansDecoder",
    "RansEncoder",
    "pmf_to_quantized_cdf",
    "pmf_to_quantized_cdf_batch",
    "rans_decode_batch",
    "rans_decode_with_rows",
    "rans_encode_batch",
    "rans_encode_with_rows",
]
