"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version. A wrapper launches its kernel for CUDA tensors and runs the plain
version only for CPU tensors; ``*_reference`` is the plain version on any
device. The kernels are built from ``csrc/`` at first use (``_build``).

  * ``bitonic_cuda.sector_sort``   -- the per-(line, sector) curvature sort
  * ``nms_cuda.greedy_nms``        -- the serial greedy feature pick
  * ``assemble_cuda.select_points`` -- the picked-coordinate copy-out
  * ``knn_cuda.knn_run``           -- exact brute-force kNN with coordinates
"""
