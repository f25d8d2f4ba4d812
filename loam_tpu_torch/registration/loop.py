"""The ICF loop's state in buffers of its own, stepped eagerly or replayed as
CUDA graphs.

``loam_tpu`` runs a registration's outer iterations as one compiled
``lax.while_loop`` (``loam_tpu/registration/icf.py:612``). The port's loop
body is :meth:`_Loop.step`: one outer iteration of every pair, reading the
loop's inputs and its carry (estimate, iteration count, status, done flags,
the detail rows, the kNN warm start) from tensors the loop owns and writing
the new carry back into them with ``copy_``, so the same step runs eagerly or
as a captured graph.

* On a CPU tensor the step runs eagerly, one host sync an iteration (the
  ``running.any()`` read), as the loop always did.
* On a CUDA tensor of a captured path (the single kNN, seeded or not, on
  preps built here or handed over by scan-to-map's cache, and the dual kNN)
  the step is captured once per key into a ``torch.cuda.CUDAGraph``: graph A
  for the first iteration (on the seeded path the kernel's cold seed, no
  warm start yet), graph B for every later one (the warm start from the last
  result; the same graph as A where nothing differs). Each iteration is one
  replay and one read of ``running.any()``: the device runs the iterations
  the eager loop runs, with the same kernels on the same buffers.
* The grid search, a ``custom_knn`` (the sharded registration, whose search
  has collectives inside), a float64 registration on the card (its plain
  search) and ``LOAM_DEBUG_NANS=1`` (its checks read values on the host)
  stay on the eager loop. The choice is made by path; a failed capture or
  replay raises.

A captured loop is cached per key: device, dtype, the shapes of every input
buffer (pairs, feature slots, target slots and boxes), the path, whether
the seeds run, ``with_matches``, the ``RegistrationParams``, and what the
kNN wrappers read while they are captured (``LOAM_KNN_LIST_PRUNE``, the
split planner's constants, the build flags). A call copies its inputs into
the buffers and resets the carry; results are returned as clones, so the
next call cannot overwrite what a caller holds. Warming a graph up runs the
step twice eagerly first (kernel build and load, cuBLAS's workspace, the
associations' constants); neither the warm-up nor the capture counts a
kernel launch, and each replay adds the launches its capture recorded.
"""

from __future__ import annotations

import collections
import contextlib
import time

import torch

from ..debug import tap_finite
from ..geometry import Pose3, norm, quat_multiply, quat_normalize, quat_rotate
from ..neighbors.grid import knn_grid
from ..ops import _build, knn_cuda
from ..ops.knn_cuda import PackedKnn, knn_dual_run, knn_run, seed_bound_from_packed, seed_bound_from_window
from ..params import RegistrationParams, TerminationType
from .associate import associate_edges, associate_planes
from .detail import IterationInfo
from .solver import _Problem, _select, lm_solve

#: The paths whose loop runs as CUDA graphs on the card.
CAPTURED_PATHS = ("single", "preps", "dual")

#: Captured loops kept per device, least recently used dropped first.
CACHE_KEYS = 6

#: The kernel wrappers a step may launch; their launch counts move on replays.
COUNTED = (knn_run, knn_dual_run)

_cache: dict = {}  # device -> OrderedDict(key -> _Loop)
_eager_only = False

#: Outer ICF iterations run since the last reset (eager steps and replays).
iterations = 0

#: The ``torch.profiler`` range around each call's iterations.
LOOP_RANGE = "icf_loop"


@contextlib.contextmanager
def _eager():
    """Run every registration inside on the eager loop: the plain version
    that the graphs are held against (``chip_smoke.py``, the ``cuda``
    tests), as a kernel is held against its plain version."""
    global _eager_only
    was, _eager_only = _eager_only, True
    try:
        yield
    finally:
        _eager_only = was


def clear_cache() -> None:
    """Drop every cached loop and its graphs."""
    _cache.clear()


def graph_stats() -> list:
    """One dict per cached loop: its path, shapes, the graphs' count,
    capture seconds (warm-up included), the graphs' memory pool in bytes
    and the replays since it was captured."""
    out = []
    for dev, loops in _cache.items():
        for loop in loops.values():
            if loop.graphs is not None:
                out.append({"device": str(dev), "path": loop.path, "seeded": loop.kernel_seed,
                            "pairs": loop.B, "edge_slots": loop.E, "planar_slots": loop.Q,
                            "graphs": len(loop.graphs), "capture_s": loop.capture_seconds,
                            "pool_bytes": loop.pool_bytes, "replays": loop.replays})
    return out


def _angle_from_identity(q: torch.Tensor) -> torch.Tensor:
    """Rotation angle of a unit quaternion (Eigen ``angularDistance`` to I)."""
    return 2.0 * torch.atan2(norm(q[..., 1:]), torch.abs(q[..., 0]))


def _alloc_like(tree):
    """Contiguous buffers shaped as ``tree``'s tensors; other leaves kept."""
    if isinstance(tree, torch.Tensor):
        return torch.empty(tree.shape, dtype=tree.dtype, device=tree.device)
    if isinstance(tree, tuple):
        parts = [_alloc_like(x) for x in tree]
        return type(tree)(*parts) if hasattr(tree, "_fields") else tuple(parts)
    return tree


def _copy_into(dst, src) -> None:
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif isinstance(dst, tuple):
        for d, s in zip(dst, src):
            _copy_into(d, s)


def _signature(tree):
    """Shapes and dtypes of ``tree``'s tensors, its other leaves as they are:
    the part of a cache key that a capture bakes in from the inputs."""
    if isinstance(tree, torch.Tensor):
        return tuple(tree.shape), tree.dtype
    if isinstance(tree, tuple):
        return tuple(_signature(x) for x in tree)
    return tree


def _capture_key(dev, path: str, kernel_seed: bool, with_matches: bool,
                 params: RegistrationParams, inputs) -> tuple:
    """Everything a capture bakes in besides the buffers' addresses."""
    return (dev, path, kernel_seed, with_matches, params, knn_cuda._list_prune(1.0),
            (knn_cuda.TARGET_BLOCKS, knn_cuda.MIN_CHUNK, knn_cuda.MAX_SPLITS),
            _build._extra_flags, _signature(inputs))


class _Loop:
    """One registration's loop: inputs, constants and carry in tensors of
    its own, :meth:`step` over them, and (on the card) its graphs.

    ``search`` is the path's search state: ``(edge_prep, planar_prep)``
    (``single``, ``preps``), ``(dual_prep,)`` (``dual``), ``(edge_grid,
    planar_grid)`` (``grid``) or ``(edge_fn, planar_fn, seed_windows)``
    (``custom``). ``target``: the target's ``(edge_points, edge_mask,
    planar_points, planar_mask)`` where the fits gather neighbours by index
    (``dual``, ``grid``, ``custom``), else None. With ``static`` the inputs
    are copied into buffers at :meth:`load` (a cached loop); without, the
    loop reads the caller's tensors (a loop made for one call)."""

    def __init__(self, path, params, with_matches, kernel_seed, source, search, target, static):
        self.path, self.params, self.kernel_seed, self.static = path, params, kernel_seed, static
        dtype, dev = source.edge_points.dtype, source.edge_points.device
        self.dev = dev
        self.B, self.E = source.edge_mask.shape
        self.Q = source.planar_mask.shape[1]
        B, I = self.B, params.max_iterations
        Em, Qm = (self.E, self.Q) if with_matches else (0, 0)
        f = dict(dtype=dtype, device=dev)
        i32 = dict(dtype=torch.int32, device=dev)
        src = (source.edge_points, source.edge_mask, source.planar_points, source.planar_mask)
        self.src = _alloc_like(src) if static else None
        self.search = _alloc_like(search) if static else None
        self.target = _alloc_like(target) if static else None
        self.init = (torch.empty((B, 4), **f), torch.empty((B, 3), **f))
        self.iters = torch.arange(I, **i32)
        self.identity = Pose3.identity(dtype, (B,), dev)
        # the carry
        self.est = Pose3(torch.empty((B, 4), **f), torch.empty((B, 3), **f))
        self.init_inv = Pose3(torch.empty((B, 4), **f), torch.empty((B, 3), **f))
        self.it = torch.empty(B, **i32)
        self.status = torch.empty(B, **i32)
        self.done = torch.empty(B, dtype=torch.bool, device=dev)
        self.running = torch.empty(B, dtype=torch.bool, device=dev)
        self.any_running = torch.empty((), dtype=torch.bool, device=dev)
        self.detail = IterationInfo(
            target_T_source_init=Pose3(torch.empty((B, I, 4), **f), torch.empty((B, I, 3), **f)),
            estimate_update=Pose3(torch.empty((B, I, 4), **f), torch.empty((B, I, 3), **f)),
            edge_match=torch.empty((B, I, Em), **i32),
            plane_match=torch.empty((B, I, Qm), **i32),
            edge_count=torch.empty((B, I), **i32),
            plane_count=torch.empty((B, I), **i32),
            edge_knn_overflow=torch.empty((B, I), **i32),
            plane_knn_overflow=torch.empty((B, I), **i32),
        )
        # the warm-start carries: the kernel's last result (seeded single
        # search), or the 3-element custom_knn's neighbours
        kE, kP = params.num_edge_neighbors, params.num_plane_neighbors

        def packed(k, n):
            return PackedKnn(torch.empty((B, n), **i32), torch.empty((B, k, n), dtype=torch.bool, device=dev),
                             *(torch.empty((B, k, n), **f) for _ in range(3)))

        self.prev = (packed(kE, self.E), packed(kP, self.Q)) if kernel_seed else None
        self.seeds = None
        if path == "custom" and search[2] is not None:
            self.seeds = tuple((*(torch.empty((B, k, n), **f) for _ in range(3)),
                                torch.empty((B, k, n), dtype=torch.bool, device=dev))
                               for k, n in ((kE, self.E), (kP, self.Q)))
        self.graphs = None  # [(CUDAGraph, launch deltas)], once captured
        self.capture_seconds = 0.0
        self.pool_bytes = 0
        self.replays = 0

    def load(self, source, init: Pose3, search, target) -> None:
        """The call's inputs: copied into the buffers (``static``) or read
        where they are."""
        src = (source.edge_points, source.edge_mask, source.planar_points, source.planar_mask)
        if self.static:
            _copy_into(self.src, src)
            _copy_into(self.search, search)
            _copy_into(self.target, target)
        else:
            self.src, self.search, self.target = src, search, target
        _copy_into(self.init, (init.rotation, init.translation))

    def reset(self) -> None:
        """The carry at the loop's start: the estimate at ``init``, no
        iteration, every pair running, the detail rows empty."""
        self.est.rotation.copy_(self.init[0])
        self.est.translation.copy_(self.init[1])
        inv = self.est.inverse()
        self.init_inv.rotation.copy_(inv.rotation)
        self.init_inv.translation.copy_(inv.translation)
        I = self.params.max_iterations
        self.it.zero_()
        self.status.fill_(TerminationType.MAX_ITER)
        self.done.zero_()
        self.running.fill_(I > 0)
        self.any_running.fill_(I > 0 and self.B > 0)
        d = self.detail
        for pose in (d.target_T_source_init, d.estimate_update):
            pose.rotation.zero_()
            pose.rotation[..., 0] = 1.0
            pose.translation.zero_()
        d.edge_match.fill_(-1)
        d.plane_match.fill_(-1)
        for x in (d.edge_count, d.plane_count, d.edge_knn_overflow, d.plane_knn_overflow):
            x.zero_()
        if self.seeds is not None:
            for x in (*self.seeds[0], *self.seeds[1]):
                x.zero_()

    def _search(self, qe, qp, first: bool):
        """The iteration's edge and planar search results, and the grid's
        overflow counts (None elsewhere)."""
        p = self.params
        kE, kP = p.num_edge_neighbors, p.num_plane_neighbors
        rE, rP = p.max_edge_neighbor_dist, p.max_plane_neighbor_dist
        if self.path == "custom":
            edge_knn, plane_knn, windows = self.search
            if windows is None:
                return edge_knn(qe), plane_knn(qp), None, None
            # the kernel's visit gates: min(warm start at the moved queries,
            # cold start); they prune visits and change no output
            (ew, pw), (es, ps) = windows, self.seeds
            eb = torch.minimum(seed_bound_from_packed(qe, *es), seed_bound_from_window(qe, *ew, kE))
            pb = torch.minimum(seed_bound_from_packed(qp, *ps), seed_bound_from_window(qp, *pw, kP))
            e_res, p_res = edge_knn(qe, eb), plane_knn(qp, pb)
            _copy_into(es, (e_res.xs, e_res.ys, e_res.zs, e_res.mask))
            _copy_into(ps, (p_res.xs, p_res.ys, p_res.zs, p_res.mask))
            return e_res, p_res, None, None
        if self.path == "grid":
            # indices into the unsorted targets: the gathered fits
            edge_grid, plane_grid = self.search
            e_res, e_ovf = knn_grid(edge_grid, qe, kE, rE, p.grid_max_per_cell)
            p_res, p_ovf = knn_grid(plane_grid, qp, kP, rP, p.grid_max_per_cell)
            return e_res, p_res, e_ovf, p_ovf
        if self.path == "dual":
            # one launch for both classes; its KnnResults take the gathered
            # fits (loam_tpu icf.py:474-477)
            e_res, p_res = knn_dual_run(self.search[0], qe, qp, kE, kP, rE, rP)
            return e_res, p_res, None, None
        # the single search; seeded, the kernel gates on the cold start and,
        # after the first iteration, on the warm start from the last result
        # (read from the carry, written back only once both searches ran)
        e_prep, p_prep = self.search
        warm = self.kernel_seed and not first
        _, em, _, pm = self.src
        e_res = knn_run(e_prep, qe, kE, rE, with_coords=True, query_mask=em,
                        seed_prev=self.prev[0] if warm else None, seed_window=self.kernel_seed)
        p_res = knn_run(p_prep, qp, kP, rP, with_coords=True, query_mask=pm,
                        seed_prev=self.prev[1] if warm else None, seed_window=self.kernel_seed)
        if self.kernel_seed:
            _copy_into(self.prev, (e_res, p_res))
        return e_res, p_res, None, None

    def step(self, first: bool) -> None:
        """One outer iteration of every pair: search, associate, solve,
        left-compose, record, and commit the new carry for the pairs still
        running (``torch.where``: a finished pair's state stays as it was)."""
        p = self.params
        I = p.max_iterations
        ep, em, pp, pm = self.src
        est, running, d = self.est, self.running, self.detail
        qe = quat_rotate(est.rotation[:, None], ep) + est.translation[:, None]
        qp = quat_rotate(est.rotation[:, None], pp) + est.translation[:, None]
        e_res, p_res, e_ovf, p_ovf = self._search(qe, qp, first)
        te, _, tp, _ = self.target if self.target is not None else (None,) * 4
        ea = associate_edges(qe, em, te, None, p, knn_result=e_res)
        pa = associate_planes(qp, pm, tp, None, p, knn_result=p_res)
        n_edge = torch.sum(ea.valid, dim=-1, dtype=torch.int32)
        n_plane = torch.sum(pa.valid, dim=-1, dtype=torch.int32)
        insufficient = (n_edge + n_plane) < p.min_associations

        problem = _Problem(qe, ea, qp, pa, prior_offset=est.compose(self.init_inv))
        solved, _ = lm_solve(problem, p)
        # both branches of loam_tpu's lax.cond, selected per pair
        identity = self.identity
        delta = Pose3(_select(insufficient, identity.rotation, solved.rotation),
                      _select(insufficient, identity.translation, solved.translation))
        new_est = Pose3(
            quat_normalize(quat_multiply(delta.rotation, est.rotation)),
            quat_rotate(delta.rotation, est.translation) + delta.translation,
        )
        # LOAM_DEBUG_NANS=1 checks every iteration's values (no-op otherwise)
        tap_finite({"delta": delta, "est": new_est, "lines": ea.line_a, "planes": pa.normal},
                   where="icf.iteration")
        converged = (_angle_from_identity(delta.rotation) < p.rotation_convergence_thresh) & (
            norm(delta.translation) < p.position_convergence_thresh
        )
        step_status = torch.where(
            insufficient,
            TerminationType.INSUFFICIENT_ASSOCIATIONS,
            torch.where(converged, TerminationType.CONVERGED, TerminationType.MAX_ITER),
        ).to(torch.int32)

        # this iteration's row (none for an insufficient one, none for a
        # pair that already stopped): iota compare, no scatter
        hit = (self.iters[None, :] == self.it[:, None]) & (running & ~insufficient)[:, None]

        def put(buf, val):
            h = hit.reshape(hit.shape + (1,) * (buf.ndim - 2))
            return torch.where(h, val[:, None], buf)

        Em, Qm = d.edge_match.shape[-1], d.plane_match.shape[-1]
        rows = [(d.target_T_source_init.rotation, est.rotation),
                (d.target_T_source_init.translation, est.translation),
                (d.estimate_update.rotation, delta.rotation),
                (d.estimate_update.translation, delta.translation),
                (d.edge_match, ea.match[:, :Em]), (d.plane_match, pa.match[:, :Qm]),
                (d.edge_count, n_edge), (d.plane_count, n_plane)]
        if e_ovf is not None:  # only the grid can overflow; the exact searches leave the zeros
            rows += [(d.edge_knn_overflow, e_ovf), (d.plane_knn_overflow, p_ovf)]
        rows = [(buf, put(buf, val)) for buf, val in rows]
        commit = running & ~insufficient
        new = [(est.rotation, _select(commit, new_est.rotation, est.rotation)),
               (est.translation, _select(commit, new_est.translation, est.translation)),
               (self.status, torch.where(running, step_status, self.status)),
               (self.done, torch.where(running, insufficient | converged, self.done)),
               (self.it, self.it + running.to(torch.int32))]
        # every read of the carry is above: write it back
        for buf, val in rows + new:
            buf.copy_(val)
        running.copy_(~self.done & (self.it < I))
        self.any_running.copy_(running.any())

    def capture(self) -> None:
        """Warm the step up on a side stream, then capture graph A (the first
        iteration) and, where the warm start makes the later ones differ,
        graph B, in one memory pool. The launch counters are as before."""
        dev = self.dev
        saved = [fn.launches for fn in COUNTED]
        t0 = time.perf_counter()
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            self.reset()
            self.step(True)
            self.step(False)
        torch.cuda.current_stream(dev).wait_stream(stream)
        torch.cuda.synchronize(dev)
        pool = torch.cuda.graph_pool_handle()
        graphs = []
        for first in (True, False) if self.kernel_seed else (True,):
            g = torch.cuda.CUDAGraph()
            before = [fn.launches for fn in COUNTED]
            with torch.cuda.graph(g, pool=pool, stream=stream):
                self.step(first)
            graphs.append((g, [fn.launches - n for fn, n in zip(COUNTED, before)]))
        torch.cuda.synchronize(dev)
        for fn, n in zip(COUNTED, saved):
            fn.launches = n
        self.graphs = graphs
        self.capture_seconds = time.perf_counter() - t0
        self.pool_bytes = sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                              if tuple(s.get("segment_pool_id", ())) == tuple(pool))

    def run(self, graph: bool):
        """The loop from its start: ``(est, status, it, detail)``, clones of
        the carry. ``graph``: replay the captured step (captured first if it
        is not yet)."""
        global iterations
        if graph and self.graphs is None:
            self.capture()
        self.reset()
        go, first = self.B > 0 and self.params.max_iterations > 0, True
        with torch.profiler.record_function(LOOP_RANGE):
            while go:
                if graph:
                    g, deltas = self.graphs[0 if first else -1]
                    g.replay()
                    self.replays += 1
                    for fn, n in zip(COUNTED, deltas):
                        fn.launches += n
                else:
                    self.step(first)
                iterations += 1
                first = False
                go = bool(self.any_running)
        clone = lambda x: x.clone()
        return (Pose3(self.est.rotation.clone(), self.est.translation.clone()), self.status.clone(),
                self.it.clone(), IterationInfo(
                    Pose3(*map(clone, self.detail.target_T_source_init)),
                    Pose3(*map(clone, self.detail.estimate_update)),
                    *map(clone, self.detail[2:])))


def run_loop(path, params, with_matches, kernel_seed, source, init, search, target, debug: bool):
    """Run the ICF loop on a path: a cached loop (eager on the CPU, CUDA
    graphs on the card) where the path is captured, else a loop made for
    this call and stepped eagerly."""
    dev = source.edge_points.device
    # on the card only a kernel search is captured: the plain search (float64)
    # copies a constant from the host
    cached = (path in CAPTURED_PATHS and not debug and not _eager_only
              and (dev.type == "cpu" or knn_cuda.kernel_takes(search[0].tT)))
    if not cached:
        loop = _Loop(path, params, with_matches, kernel_seed, source, search, target, static=False)
        loop.load(source, init, search, target)
        return loop.run(graph=False)
    key = _capture_key(dev, path, kernel_seed, with_matches, params,
                       ((source.edge_points, source.edge_mask, source.planar_points, source.planar_mask),
                        search, target))
    loops = _cache.setdefault(dev, collections.OrderedDict())
    loop = loops.pop(key, None)
    if loop is None:
        loop = _Loop(path, params, with_matches, kernel_seed, source, search, target, static=True)
    loops[key] = loop
    while len(loops) > CACHE_KEYS:
        loops.popitem(last=False)
    loop.load(source, init, search, target)
    return loop.run(graph=dev.type == "cuda")
