"""The mesh, and the sharded batch entry points: extraction, pair
registration and offline odometry.

Counterpart of ``loam_tpu.parallel.sharding``. ``loam_tpu`` places its
inputs over a ``jax.sharding.Mesh`` and lets XLA partition the single-device
programs; PyTorch runs one process (rank) per GPU under ``torch.distributed``.
The port's :class:`Mesh` joins the two: a rank holds one or more shards, all
on its one device (several GPUs means several ranks), and the ranks form the
mesh's process group. Inputs are replicated (every rank passes all frames),
each shard computes its block, and the blocks are gathered
(``collectives.gather``), so every rank returns the whole result.

Axes, as in ``loam_tpu``:

  * ``data`` -- frames or pairs, in contiguous blocks. Consecutive pairs need
    each block's first frame from the block to its right: ``loam_tpu``'s
    ``ppermute`` halo, here a gather of every rank's first frame.
  * ``line`` -- scan lines within extraction. Curvature and validity are
    stencils along a line only (``features/curvature.py``), so a line block
    needs no halo; its picks count flat scan indices from its first line.

Each call of an entry point here and in ``distributed`` is one program
(``program.py``), as ``loam_tpu`` jits each: eager on the CPU (and over
gloo), on the card one CUDA graph with the gathers inside it, in the bodies
of its conditional nodes too (the ICF loop's WHILE node holds the sharded
search, the keyframe's IF node the sharded insert), one ``cudaGraphLaunch``
a call and no host read, at every world size. A program is cached under its
mesh's ``token``, unique in the process: a mesh made on another group never
replays it, a call on a mesh whose group was destroyed raises, and
:meth:`Mesh.release` drops the mesh's programs and frees its gather's
buffers before its group goes.
"""

from __future__ import annotations

import dataclasses
import itertools
import zlib
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from .. import program
from ..device import place, resolve
from ..features import FeatureSet
from ..features.curvature import compute_curvature, compute_valid_points, validate_scan
from ..features.extract import _extract_core
from ..geometry import Pose3
from ..odometry.offline import compose_trajectory
from ..params import FeatureExtractionParams, LidarParams, RegistrationParams
from ..registration import RegistrationDetail, azimuth_sort_features, register_features_batch
from ..registration.detail import tree_map
from ..registration.loop import driver_program
from ..ops.peer_cuda import PeerMailbox, check_hosts, islands, takes_device_tensors
from .collectives import gather

_TOKENS = itertools.count()


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A ("data", "line") mesh of shards over the ranks of a process group.

    Global shard ``g`` sits at ``(g // line, g % line)`` of the
    (data, line) grid, ``loam_tpu``'s process-major device order; rank ``r``
    holds shards ``r * local .. r * local + local - 1``, whole rows of the
    grid. The ranks sit on hosts (:attr:`hosts`); the ranks of a host whose
    cards reach each other's memory form an island (:attr:`islands`), and
    on the card the collectives run over NVLink within an island and
    through the ranks' host proxies over TCP between islands, the same bits
    either way.
    """

    #: This rank's shards, one ``torch.device`` each, all the same device.
    devices: Tuple[torch.device, ...]
    #: The ``torch.distributed`` group of the ranks, or None for one process.
    group: Optional[object]
    #: Shards along each axis: ``{"data": ..., "line": ...}``.
    shape: Dict[str, int]
    #: Global index of each of this rank's shards.
    shard_ids: Tuple[int, ...]
    #: This rank's buffers of the collectives over peer memory and its
    #: proxy to other hosts (``ops/peer_cuda.py``) on a CUDA mesh with a
    #: group, else None.
    peer: Optional[PeerMailbox] = None
    #: Each rank's host label: ``make_mesh(hosts=)``, or on the card each
    #: rank's machine; None for a CPU mesh made without ``hosts``.
    hosts: Optional[Tuple[str, ...]] = None
    #: Unique in this process: the key of the mesh's cached programs.
    token: int = dataclasses.field(default_factory=lambda: next(_TOKENS))

    axis_names = ("data", "line")

    @property
    def device(self) -> torch.device:
        """The device of this rank's shards."""
        return self.devices[0]

    @property
    def size(self) -> int:
        """Shards over all ranks."""
        return self.shape["data"] * self.shape["line"]

    def rows(self) -> Tuple[int, int]:
        """This rank's rows of the data axis: (first, count)."""
        line = self.shape["line"]
        return self.shard_ids[0] // line, len(self.shard_ids) // line

    def shards_along(self, axis: str) -> Tuple[int, Tuple[int, ...]]:
        """(shards along ``axis``, this rank's shards' indices on it), for the
        functions that shard one axis; the mesh's other axis must be 1."""
        if axis not in self.shape:
            raise ValueError(f"mesh has no axis {axis!r}; its axes are {self.axis_names}")
        if self.size != self.shape[axis]:
            raise ValueError(f"sharding over {axis!r} needs the other mesh axis to be 1, "
                             f"got {self.shape}")
        return self.shape[axis], self.shard_ids

    @property
    def islands(self) -> Optional[Tuple[Tuple[int, ...], ...]]:
        """The ranks that reach each other's memory, a tuple a host's
        island (``peer_cuda.islands``): on the card the mailbox's, which
        also asks the cards; on the CPU the ranks of each host label."""
        if self.peer is not None:
            return self.peer.islands
        return None if self.hosts is None else islands(self.hosts, lambda a, b: True)

    def release(self) -> None:
        """Drop the programs cached for this mesh and free its gather's
        buffers, which the other ranks map, and stop its proxy: every rank
        releases the mesh, before destroying its group."""
        program.forget(mesh=self.token)
        if self.peer is not None:
            self.peer.release(wait=_live(self.group))


def _live(group) -> bool:
    """Whether ``group`` is still registered (not destroyed)."""
    try:
        dist.get_rank(group)
    except ValueError:  # a destroyed group is no longer registered
        return False
    return True


def require_live(mesh: Mesh) -> None:
    """Raise if the mesh's process group was destroyed: the mesh's gathers
    would wait for ranks that left it."""
    if mesh.group is not None and not _live(mesh.group):
        raise RuntimeError("the mesh's process group was destroyed; make a new mesh on a live group")


def run_program(mesh: Mesh, key: tuple, inputs, fn, reg_params: Optional[RegistrationParams], **info):
    """``fn(buffers)`` as the one program of a sharded driver call on
    ``mesh`` (``loop.driver_program``: cached, its key holding the mesh's
    token; eager only under ``LOAM_DEBUG_NANS=1``, which reads the host by
    design), inside ``program.DRIVER_RANGE``. Returns ``(program,
    output)``."""
    require_live(mesh)
    prog = driver_program(mesh.device, key + (mesh.token,), inputs, reg_params, mesh=mesh.token, **info)
    with torch.profiler.record_function(program.DRIVER_RANGE):
        return prog, prog.run(fn, inputs)


def make_mesh(devices: Optional[list] = None, line_axis: int = 1, group=None, hosts=None) -> Mesh:
    """A ("data", "line") mesh of this rank's shards ``devices`` in the
    process group ``group``.

    ``devices``: one entry a shard, all the same device; a device may repeat
    (four shards on one GPU, eight on the CPU as the tests run). ``None`` is
    one shard on this rank's GPU (``torch.cuda.current_device()``), and
    raises PyTorch's CUDA error on a machine without one (``device.py``).
    ``line_axis`` of each rank's shards go to the line axis, the rest to the
    data axis: ``shape = {"data": world * local / line_axis, "line":
    line_axis}``. ``group``: the ranks' ``torch.distributed`` group (the
    caller initialises it), or None for one process. With a group every
    rank calls it: one eager gather, on this rank's device (on the host for
    a gloo group), checks that the ranks agree on the shards a rank,
    ``line_axis`` (the shape assumes it) and ``hosts``, and so opens the
    group's communicator on the current stream (a rank's first collective
    on a side stream hangs a later graph capture under NCCL 2.28.9). On a
    CUDA device the ranks then set up the mesh's collectives
    (``ops/peer_cuda.PeerMailbox``): over NVLink among the ranks of a host
    whose cards reach each other's memory (an island), through each rank's
    host proxy over TCP between islands; a socket that cannot be set up
    raises.

    ``hosts``: each rank's host, one label a rank (equal labels, one host),
    the same sequence on every rank; by default each rank's machine (its
    host name and boot id). Ranks of one machine labelled apart talk over
    the proxy as if on two hosts: how the tests and ``chip_smoke.py`` run a
    mesh across hosts on one machine. On the CPU it only names the mesh's
    islands (:attr:`Mesh.islands`); the gloo group crosses processes and
    hosts alike.
    """
    devs = tuple(resolve(d) for d in ([None] if devices is None else devices))
    if not devs:
        raise ValueError("a mesh needs at least one shard")
    if any(d != devs[0] for d in devs):
        raise ValueError(f"a rank's shards must share one device, got {sorted(set(map(str, devs)))}: "
                         f"several GPUs means several ranks")
    n = len(devs)
    if line_axis < 1 or n % line_axis:
        raise ValueError(f"{n} shards not divisible by line_axis={line_axis}")
    world = 1 if group is None else dist.get_world_size(group)
    rank = 0 if group is None else dist.get_rank(group)
    labels = None if hosts is None else check_hosts(hosts, world)
    if group is not None:
        on = devs[0] if takes_device_tensors(group) else torch.device("cpu")
        named = -1 if labels is None else zlib.crc32("\0".join(labels).encode())
        mine = torch.tensor([[n, line_axis, named]], dtype=torch.int64, device=on)
        every = torch.empty((world, 3), dtype=torch.int64, device=on)
        dist.all_gather_into_tensor(every, mine, group=group)
        if (every != mine).any():
            raise ValueError(f"the ranks' meshes differ: (shards, line_axis, a checksum of hosts) of each rank "
                             f"{every.tolist()}")
    peer = PeerMailbox(group, devs[0], labels) if group is not None and devs[0].type == "cuda" else None
    return Mesh(devs, group, {"data": world * n // line_axis, "line": line_axis},
                tuple(rank * n + j for j in range(n)), peer, peer.hosts if peer is not None else labels)


def _blocks(count: int, what: str, mesh: Mesh) -> Tuple[int, int]:
    """This rank's contiguous block of ``count`` items split over the data
    axis: (first, end)."""
    data = mesh.shape["data"]
    if count % data:
        raise ValueError(f"{count} {what} do not split evenly over the mesh's data axis of {data}")
    first, rows = mesh.rows()
    per = count // data
    return first * per, (first + rows) * per


def _per_row(fn, count: int, mesh: Mesh, *trees) -> tuple:
    """``fn`` of each data row's block of this rank's ``count`` items (the
    leading axis of ``trees``' leaves), a tuple of trees, each concatenated
    in row order. Every shard's block is one call at one shape, whatever
    the rank holds besides, as each device runs its own block in
    ``loam_tpu``'s ``shard_map``: a batch's sums (the ICF's normal
    equations) round alike on one rank of N shards and on N ranks of one."""
    _, rows = mesh.rows()
    n = count // rows
    parts = [fn(*(tree_map(lambda x, i=i: x[i * n:(i + 1) * n], t) for t in trees)) for i in range(rows)]
    return tuple(tree_map(lambda *xs: torch.cat(xs), *outs) for outs in zip(*parts))


def _extract_lines(pts: torch.Tensor, lidar: LidarParams, params: FeatureExtractionParams,
                   line: int) -> FeatureSet:
    """Features of frames (B, L, P, 3), extracted per line block of
    ``L / line`` lines (one shard each) and joined along the slots, which
    are line-major."""
    L = lidar.scan_lines
    if L % line:
        raise ValueError(f"{L} scan lines do not split evenly over the mesh's line axis of {line}")
    n = L // line
    sub = dataclasses.replace(lidar, scan_lines=n)
    parts = []
    for b in range(line):
        blk = pts[:, b * n:(b + 1) * n]
        parts.append(_extract_core(blk, compute_curvature(blk, sub, params),
                                   compute_valid_points(blk, sub, params), sub, params, line0=b * n))
    return tree_map(lambda *xs: torch.cat(xs, dim=1), *parts)


def _scans(scans, lidar: LidarParams, mesh: Mesh) -> torch.Tensor:
    pts = validate_scan(place(scans, mesh.device), lidar)
    if pts.ndim != 4:
        raise ValueError(f"expected a batch of scans, got shape {tuple(pts.shape)}")
    return pts


def extract_features_sharded(
    scans,
    lidar: LidarParams,
    mesh: Mesh,
    params: FeatureExtractionParams = FeatureExtractionParams(),
) -> FeatureSet:
    """Batched feature extraction with frames sharded over "data" and scan
    lines over "line": equal to ``extract_features_batch`` of ``scans``
    (F, L, P, 3) or (F, L*P, 3), which every rank passes whole. The frame
    count must be a multiple of the data axis, the line count of the line
    axis. One program a call (the module docstring)."""
    pts = _scans(scans, lidar, mesh)
    lo, hi = _blocks(pts.shape[0], "frames", mesh)

    def fn(p):
        return gather(mesh, _extract_lines(p[lo:hi], lidar, params, mesh.shape["line"]))

    prog, out = run_program(mesh, ("extract_sharded", lidar, params), pts, fn, None,
                            path="extract_sharded", frames=pts.shape[0])
    return prog.own(out)


def register_pairs_sharded(
    source: FeatureSet,
    target: FeatureSet,
    init: Pose3,
    mesh: Mesh,
    params: RegistrationParams = RegistrationParams(),
) -> Tuple[Pose3, RegistrationDetail]:
    """Batched pair registration with the pair axis sharded over "data":
    each shard registers its block of pairs in one
    ``register_features_batch`` and the blocks are gathered. Every rank
    passes all pairs; the pair count must be a multiple of the data axis. One program a call (the module
    docstring)."""
    lo, hi = _blocks(source.edge_mask.shape[0], "pairs", mesh)
    on = lambda x: x.to(mesh.device)

    def fn(bufs):
        block = lambda x: x[lo:hi]
        src, tgt, ini = (tree_map(block, x) for x in bufs)
        pose, detail = _per_row(lambda *b: register_features_batch(*b, params), hi - lo, mesh, src, tgt, ini)
        return gather(mesh, (pose, detail))

    prog, out = run_program(mesh, ("pairs_sharded",), (source.map(on), target.map(on), tree_map(on, init)),
                            fn, params, path="pairs_sharded", pairs=source.edge_mask.shape[0])
    return prog.own(out)


def odometry_offline_sharded(
    scans,
    lidar: LidarParams,
    mesh: Mesh,
    feat_params: FeatureExtractionParams = FeatureExtractionParams(),
    reg_params: RegistrationParams = RegistrationParams(),
) -> Tuple[Pose3, RegistrationDetail]:
    """Whole-trajectory odometry with the frame axis sharded over the mesh:
    ``odometry_offline`` with its defaults (``chunk_pairs=1``, no motion
    prior), whose pairs are independent.

    The frames split into contiguous blocks over "data" (their count must be
    a multiple of it), lines over "line". Each rank extracts its block and
    registers the pairs that start in it, the last one against the first
    frame of the block to its right (the halo), one batch a data row of its
    shards; the relative poses are gathered and composed on every rank. One
    program a call (the module docstring), as ``odometry_offline``'s.
    """
    pts = _scans(scans, lidar, mesh)
    F = pts.shape[0]
    if F < 2:
        raise ValueError(f"odometry needs at least 2 frames, got {F}")
    lo, hi = _blocks(F, "frames", mesh)

    def fn(p):
        feats = azimuth_sort_features(_extract_lines(p[lo:hi], lidar, feat_params, mesh.shape["line"]))
        n = hi - lo
        heads = gather(mesh, feats.map(lambda x: x[:1]))  # every rank's first frame
        if hi < F:
            frames = tree_map(lambda x, h: torch.cat([x, h[hi // n:hi // n + 1]]), feats, heads)
        else:
            # the last block has one pair fewer: pad with its last frame
            # against itself, so every rank gathers n pairs; the pad is cut below
            frames = feats.map(lambda x: torch.cat([x, x[-1:]]))
        src, tgt = frames.map(lambda x: x[1:]), frames.map(lambda x: x[:-1])
        init = Pose3.identity(feats.edge_points.dtype, (n,), mesh.device)
        rel, details = _per_row(lambda *b: register_features_batch(*b, reg_params, reorder_mode="none"), n,
                                mesh, src, tgt, init)
        rel, details = gather(mesh, (rel, details))
        cut = lambda x: x[:F - 1]
        return compose_trajectory(tree_map(cut, rel)), tree_map(cut, details)

    prog, out = run_program(mesh, ("offline_sharded", lidar, feat_params), pts, fn, reg_params,
                            path="offline_sharded", frames=F)
    return prog.own(out)
