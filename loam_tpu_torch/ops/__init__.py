"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version. A wrapper launches its kernel for CUDA tensors and runs the plain
version only for CPU tensors; ``*_reference`` is the plain version on any
device. The kernels are built from ``csrc/`` at first use (``_build``).

  * ``bitonic_cuda.sector_sort``   -- the per-(line, sector) curvature sort
  * ``nms_cuda.greedy_nms``        -- the serial greedy feature pick
  * ``assemble_cuda.select_points`` -- the picked-coordinate copy-out
  * ``knn_cuda.knn_run``           -- exact brute-force kNN with coordinates
  * ``knn_cuda.knn_dual_run``      -- the edge and the planar kNN in one launch
  * ``peer_cuda.peer_gather``      -- the mesh's gather of a list of tensors over peer memory
  * ``peer_cuda.peer_sum``         -- the mesh's sum in global shard order, the same kernel

``knn_pallas`` is ``loam_tpu.ops.knn_pallas``'s one-shot prep + search.

``morton`` (Morton keys) is plain PyTorch: ``loam_tpu`` has no kernel there.
"""

from .knn_cuda import knn_pallas

__all__ = ["knn_pallas"]
