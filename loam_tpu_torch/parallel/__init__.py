"""Multi-device and multi-process execution: a mesh of shards over a
``torch.distributed`` group.

Counterpart of ``loam_tpu.parallel``, which runs one controller over a
``jax.sharding.Mesh`` (``jax.distributed`` across hosts) and lets XLA insert
the collectives. Here a rank is one process with one device, holding one or
more shards of the mesh on it; the ranks form the mesh's process group
(gloo for CPU tensors, NCCL for CUDA ones, which sets the mesh up), and the
two collectives the entry points need, a gather and a sum in fixed order,
are written out in ``collectives``: on the card one hand-written kernel over
peer memory (``ops/peer_cuda.py``) for both, which every pair of the mesh's
cards must be able to reach.

Axes (``sharding``): ``data`` -- frames, pairs, map and edge shards;
``line`` -- scan lines within extraction. ``sharding`` holds the batch entry
points, ``distributed`` the sharded-target registration, voxel map and
scan-to-map, ``pose_graph.optimize_pose_graph_sharded`` the distributed
pose-graph solve.
"""

from .sharding import (
    Mesh,
    extract_features_sharded,
    make_mesh,
    odometry_offline_sharded,
    register_pairs_sharded,
)

__all__ = [
    "make_mesh",
    "extract_features_sharded",
    "odometry_offline_sharded",
    "register_pairs_sharded",
]
