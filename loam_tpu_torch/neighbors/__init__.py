"""Neighbor search: the exact brute-force search (the reference's KD-tree,
``kdtree.cpp:10-28``) and the voxel-grid search for map-scale targets, and
``knn_oracle``, the NumPy reference they are held to."""

from .bruteforce import KnnResult, knn, knn_oracle, topk_min
from .grid import GridIndex, build_grid, knn_grid

__all__ = ["GridIndex", "KnnResult", "build_grid", "knn", "knn_grid", "knn_oracle", "topk_min"]
