"""Sharded indexes of the PyTorch port (counterpart of
hnsw_nsg_tpu/parallel): a single controller over a mesh of devices."""

from .mesh import (
    AXIS, DCN_AXIS, Mesh, MultiSliceCNNSIndex, ShardedCNNSIndex,
    ShardedFlatIndex, ShardedGraphIndex, make_mesh, make_multislice_mesh,
    sharded_knn_build_step,
)

__all__ = [
    "AXIS", "DCN_AXIS", "Mesh", "MultiSliceCNNSIndex", "ShardedCNNSIndex",
    "ShardedFlatIndex", "ShardedGraphIndex", "make_mesh",
    "make_multislice_mesh", "sharded_knn_build_step",
]
