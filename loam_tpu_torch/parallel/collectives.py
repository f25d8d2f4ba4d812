"""The two collectives of the port's mesh: gather and a sum in fixed order.

``loam_tpu`` leaves its collectives to XLA (``ppermute``, ``psum``, the
all-gather of a sharded output). Here they are written out over a
:class:`~loam_tpu_torch.parallel.sharding.Mesh`: on the card through the
mesh's gather over peer memory (``ops/peer_cuda.py``, a hand-written kernel,
at every world size), for CPU tensors through ``all_gather_into_tensor`` on
the mesh's gloo group; with no group nothing crosses a process.

A per-shard tensor leads with this rank's shards, in the mesh's local order.
Ranks hold consecutive blocks of global shards (``rank * local + j``), so
the ranks' blocks concatenated in rank order are in global shard order.

:func:`sum` adds the gathered partials one after another in global shard
order instead of an ``all_reduce``, whose order of additions is the
backend's. Every rank then holds the same bits, which the replicated control
flow above needs: the ICF loop's ``running.any()``, the keyframe decision and
the pose graph's accept test branch on reduced values, and two ranks that
branch apart wait on each other's next collective forever. The same order
makes a run on 2 ranks of 2 shards equal to one on 1 rank of 4 shards.

Both are capture-safe: one output allocated before the collective, no host
value, so a sharded driver's program (``program.py``) captures them into its
CUDA graph on the card, in the bodies of its conditional nodes too. On the
CPU (gloo) they run eagerly, as every program does there.
"""

from __future__ import annotations

import torch

from ..ops.peer_cuda import peer_gather


def gather(mesh, x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` (a leading axis of the same length on each rank)
    concatenated along that axis in rank order: for a per-shard tensor,
    (global shards, ...) in global order. ``x`` itself without a group."""
    if mesh.group is None:
        return x
    return peer_gather(x, mesh.peer, mesh.group)


def sum(mesh, x: torch.Tensor) -> torch.Tensor:  # noqa: A001 -- the collective's name
    """The sum over every shard of the per-shard ``x`` (L, ...), added one
    shard after another in global shard order, the same bits on every rank."""
    parts = gather(mesh, x)
    out = parts[0].clone()
    for part in parts[1:]:
        out += part
    return out
