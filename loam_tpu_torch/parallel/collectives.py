"""The two collectives of the port's mesh: gather and a sum in fixed order.

``loam_tpu`` leaves its collectives to XLA (``ppermute``, ``psum``, the
all-gather of a sharded output). Here they are written out over a
:class:`~loam_tpu_torch.parallel.sharding.Mesh`: on the card through the
mesh's kernel over peer memory (``ops/peer_cuda.py``, hand-written, at every
world size), for CPU tensors through ``all_gather_into_tensor`` on the
mesh's gloo group; with no group nothing crosses a process.

A per-shard tensor leads with this rank's shards, in the mesh's local order.
Ranks hold consecutive blocks of global shards (``rank * local + j``), so
the ranks' blocks concatenated in rank order are in global shard order.

:func:`gather` takes a tree of tensors and gathers all its leaves in one
collective (one launch on the card, one packed ``all_gather_into_tensor``
over gloo), each leaf as it would be gathered alone.

:func:`sum` adds every shard's block one after another in global shard
order instead of an ``all_reduce``, whose order of additions is the
backend's. Every rank then holds the same bits, which the replicated control
flow above needs: the ICF loop's ``running.any()``, the keyframe decision and
the pose graph's accept test branch on reduced values, and two ranks that
branch apart wait on each other's next collective forever. The same order
makes a run on 2 ranks of 2 shards equal to one on 1 rank of 4 shards. On
the card the kernel adds as it receives and never makes the gathered blocks.

Both are capture-safe: outputs allocated before the collective, no host
value, so a sharded driver's program (``program.py``) captures them into its
CUDA graph on the card, in the bodies of its conditional nodes too. On the
CPU (gloo) they run eagerly, as every program does there.
"""

from __future__ import annotations

import torch

from ..ops.peer_cuda import peer_gather, peer_sum


def _flatten(tree, leaves: list):
    """The tensors of ``tree`` (a tensor, ``None``, or NamedTuples, tuples
    and lists of trees) appended to ``leaves``, in order; returns a function
    that rebuilds the tree from a list of tensors in that order."""
    if tree is None:
        return lambda _: None
    if isinstance(tree, torch.Tensor):
        i = len(leaves)
        leaves.append(tree)
        return lambda got: got[i]
    if isinstance(tree, (tuple, list)):
        parts = [_flatten(x, leaves) for x in tree]
        if hasattr(tree, "_fields"):
            return lambda got: type(tree)(*(p(got) for p in parts))
        return lambda got: type(tree)(p(got) for p in parts)
    raise TypeError(f"a gathered tree holds tensors, None, NamedTuples, tuples and lists, not {type(tree)}")


def gather(mesh, tree):
    """Every rank's blocks of ``tree``'s tensors (each with a leading axis
    of the same length on each rank), each concatenated along that axis in
    rank order, in one collective: for a per-shard tensor, (global shards,
    ...) in global order. ``tree`` itself without a group."""
    if mesh.group is None:
        return tree
    leaves = []
    rebuild = _flatten(tree, leaves)
    return rebuild(peer_gather(leaves, mesh.peer, mesh.group))


def sum(mesh, x: torch.Tensor) -> torch.Tensor:  # noqa: A001 -- the collective's name
    """The sum over every shard of the per-shard ``x`` (L, ...), added one
    shard after another in global shard order, the same bits on every rank."""
    if mesh.group is None:
        out = x[0].clone()
        for part in x[1:]:
            out += part
        return out
    return peer_sum(x, mesh.peer, mesh.group)
