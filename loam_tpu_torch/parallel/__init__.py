"""Multi-device and multi-process execution: a mesh of shards over a
``torch.distributed`` group.

Counterpart of ``loam_tpu.parallel``, which runs one controller over a
``jax.sharding.Mesh`` (``jax.distributed`` across hosts) and lets XLA insert
the collectives. Here a rank is one process with one device, holding one or
more shards of the mesh on it; the ranks form the mesh's process group
(gloo for CPU tensors, NCCL for CUDA ones, which sets the mesh up), and the
two collectives the entry points need, a gather and a sum in fixed order,
are written out in ``collectives``: on the card one hand-written kernel for
both (``ops/peer_cuda.py``), which reaches the ranks of its host whose
cards reach each other's memory over NVLink and every other rank -- on
another host (``make_mesh(hosts=)``, by default each rank's machine) or on
a card it cannot reach -- through a host proxy over TCP, captured in CUDA
graphs either way.

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
