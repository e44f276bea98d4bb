"""Sharded retrieval over a mesh of devices, tensor-parallel decoders and
the multi-host index build (port of ``easyrag_tpu/parallel``)."""

from .mesh import Mesh, data_model_mesh, make_mesh  # noqa: F401
from .sharded import (  # noqa: F401
    ShardedDenseIndex,
    ShardedResidentSparseIndex,
    ShardedSparseScorer,
)
from .tp import shard_decoder_params  # noqa: F401
