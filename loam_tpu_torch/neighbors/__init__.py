"""Exact neighbor search (the reference's KD-tree, ``kdtree.cpp:10-28``)."""

from .bruteforce import KnnResult, knn, topk_min

__all__ = ["KnnResult", "knn", "topk_min"]
