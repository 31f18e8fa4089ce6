"""(data, model) mesh parallelism over torch.distributed: the data- and
tensor-parallel train step, batched inference, and the batch-split
codecs.  Exports the JAX package's names (hesic_tpu/parallel), and the
port's split codec calls and ``unshard_params``."""

from .codec import (sharded_codec_roundtrip, split_compress_fast,
                    split_compress_wavefront, split_decompress_fast_batch)
from .mesh import (DATA_AXIS, MODEL_AXIS, batch_sharding, make_mesh,
                   make_parallel_apply, make_parallel_train_step,
                   mesh_device, param_sharding, replicated, shard_batch,
                   shard_params, unshard_params)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "batch_sharding",
    "make_mesh",
    "make_parallel_apply",
    "make_parallel_train_step",
    "mesh_device",
    "param_sharding",
    "replicated",
    "shard_batch",
    "shard_params",
    "sharded_codec_roundtrip",
    "split_compress_fast",
    "split_compress_wavefront",
    "split_decompress_fast_batch",
    "unshard_params",
]
