"""The two collectives of the port's mesh: gather and a sum in fixed order.

``loam_tpu`` leaves its collectives to XLA (``ppermute``, ``psum``, the
all-gather of a sharded output). Here they are written out, over the
``torch.distributed`` group of a :class:`~loam_tpu_torch.parallel.sharding.Mesh`
(gloo for CPU tensors, NCCL for CUDA tensors); with no group nothing crosses
a process.

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

Both are capture-safe: one output allocated before the collective and
written by ``all_gather_into_tensor``, no host value, so a sharded driver's
program (``program.py``) captures them into its CUDA graph on the card. In
the bodies of its conditional nodes only at world size 1: with more ranks
NCCL's collective is accepted in a plain graph but refused in a WHILE body
(the capture's end fails with ``cudaErrorInvalidValue``; NCCL 2.28.9, CUDA
12.8, 4 ranks; ``chip_smoke.py`` phase 17 probes it on every run), so a
program whose collectives run inside such a body runs eagerly at world
size > 1 (:func:`in_conditional_bodies`), as ``LOAM_DEBUG_NANS=1`` runs
eagerly by design, and :func:`gather` raises if one is captured there. On
the CPU (gloo) they run eagerly, as every program does there.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .. import program


def in_conditional_bodies(mesh) -> bool:
    """Whether a program may capture the collectives of ``mesh`` inside
    the body of a conditional node: at world size 1 only (module
    docstring)."""
    return mesh.group is None or dist.get_world_size(mesh.group) == 1


def gather(mesh, x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` (a leading axis of the same length on each rank)
    concatenated along that axis in rank order: for a per-shard tensor,
    (global shards, ...) in global order. ``x`` itself without a group."""
    if mesh.group is None:
        return x
    world = dist.get_world_size(mesh.group)
    if world > 1 and program.capturing_body():
        # a program that forgot to run eagerly here (sharding.run_program's
        # ``bodies``) fails now, not at the capture's end on some ranks
        raise RuntimeError(f"a collective captured inside a conditional body at world size {world}: NCCL "
                           f"refuses it there, so the program must run eagerly (in_conditional_bodies)")
    # bool travels as uint8: not every backend reduces or gathers bool
    wire = (x.to(torch.uint8) if x.dtype == torch.bool else x).contiguous()
    out = torch.empty((world * wire.shape[0],) + tuple(wire.shape[1:]), dtype=wire.dtype,
                      device=wire.device)
    dist.all_gather_into_tensor(out, wire, group=mesh.group)
    return out.to(torch.bool) if x.dtype == torch.bool else out


def sum(mesh, x: torch.Tensor) -> torch.Tensor:  # noqa: A001 -- the collective's name
    """The sum over every shard of the per-shard ``x`` (L, ...), added one
    shard after another in global shard order, the same bits on every rank."""
    parts = gather(mesh, x)
    out = parts[0].clone()
    for part in parts[1:]:
        out += part
    return out
