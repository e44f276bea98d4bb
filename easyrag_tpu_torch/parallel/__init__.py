"""Sharded retrieval over a mesh of devices and the multi-host index build
(port of ``easyrag_tpu/parallel``; tensor parallelism is not ported yet)."""

from .mesh import Mesh, data_model_mesh, make_mesh  # noqa: F401
from .sharded import (  # noqa: F401
    ShardedDenseIndex,
    ShardedResidentSparseIndex,
    ShardedSparseScorer,
)
