"""The ICF loop: ``lax.while_loop`` as a schedule of steps over the loop's
own carry, one program with the registration around it.

``loam_tpu`` runs a registration's outer iterations as one compiled
``lax.while_loop`` (``loam_tpu/registration/icf.py:612``). The port's loop
body is :meth:`_Loop.step`: one outer iteration of every pair, reading the
loop's inputs and its carry (estimate, iteration count, status, done flags,
the detail rows, the kNN warm start) and writing the new carry back into the
carry's tensors with ``copy_``, its last write the device flag
``any_running``. :meth:`_Loop.schedule` is the while loop bounded by
``max_iterations``: the first iteration, then
``program.while_loop(any_running, step)`` -- a host loop eagerly (it stops
at the first false flag, as the while loop does), one CUDA-graph WHILE node
in a capture, so the device runs exactly the iterations the while loop runs
with no host read, and the graph holds one step whatever
``max_iterations`` is.

The registration around it (``icf._register_impl``: the feature sort, the
kNN preps or the voxel grids, the loop, the matches mapped back) is one
``program.Program`` per key on the kNN paths (the single kNN, seeded or
not, on preps built inside or handed over by scan-to-map's cache, and the
dual kNN; float32 or, with the plain search, float64), on the grid path
(both grids built before the WHILE node, as ``loam_tpu`` builds them before
its ``lax.while_loop``, and searched inside it, the overflow counts written
into the carry's detail rows) and on the sharded path (the sharded
registration, ``parallel.distributed``: the search's gathers and merge
inside the step, so inside the WHILE node): eager on the CPU, one CUDA
graph on the card, one replay a registration. Inside another program (a
scan-to-map or scan-to-scan frame, a streaming chunk, a sharded step) it
runs inline, into that program. Two paths stay eager by design, on a loop
made for the call: a caller's ``custom_knn`` (which may read the host) and
``LOAM_DEBUG_NANS=1`` (its checks read values on the host). The choice is
made by path; a failed capture or replay raises.

A cached program's key holds the device, the path, whether the seeds run,
``with_matches``, the ``RegistrationParams``, the shapes of every input and
what the kNN wrappers read while they are captured (:func:`knob_key`), and
on the sharded path the mesh's token (unique in the process, so a program
captured on one process group is never replayed on another). The
outer iterations are counted by :data:`ITERATIONS` (``iterations`` reads
it), on the device inside the WHILE body (``program.Counter``).
"""

from __future__ import annotations

import os

import torch

from .. import program
from ..debug import debug_nans_enabled, tap_finite
from ..geometry import Pose3, norm, quat_multiply, quat_normalize, quat_rotate
from ..neighbors.grid import knn_grid
from ..ops import _build, knn_cuda
from ..ops.knn_cuda import PackedKnn, knn_dual_run, knn_run, seed_bound_from_packed, seed_bound_from_window
from ..params import RegistrationParams, TerminationType
from ..program import CACHE_KEYS, _cache, clear_cache, graph_stats  # noqa: F401  (the loop's API)
from ..program import eager as _eager  # noqa: F401
from .associate import associate_edges, associate_planes
from .detail import IterationInfo
from .solver import _Problem, _select, lm_solve

#: The paths whose registration is one cached program (one CUDA graph on the card).
CAPTURED_PATHS = ("single", "preps", "dual", "grid", "sharded")

#: The kernel wrappers a step may launch.
COUNTED = (knn_run, knn_dual_run)

#: Outer ICF iterations run (eager steps and replays); ``iterations`` reads it.
ITERATIONS = program.Counter("icf_iterations")

#: The ``torch.profiler`` range around each registration's iterations.
LOOP_RANGE = "icf_loop"


def __getattr__(name):
    if name == "iterations":
        return ITERATIONS.value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def knob_key() -> tuple:
    """What a capture bakes in besides shapes and parameters: the
    environment's algorithm switches (``LOAM_ICF_DUAL_KNN``,
    ``LOAM_KNN_SEED``, ``LOAM_S2M_PREP_CACHE``, ``LOAM_KNN_LIST_PRUNE``),
    the kNN split planner's constants and the kernels' build flags."""
    env = tuple(os.environ.get(k) for k in ("LOAM_ICF_DUAL_KNN", "LOAM_KNN_SEED",
                                            "LOAM_S2M_PREP_CACHE", "LOAM_KNN_LIST_PRUNE"))
    return (env, (knn_cuda.TARGET_BLOCKS, knn_cuda.MIN_CHUNK, knn_cuda.MAX_SPLITS),
            _build._extra_flags)


def driver_program(dev: torch.device, key: tuple, inputs, reg_params: RegistrationParams,
                   **info) -> program.Program:
    """The program of a driver call (a frame, a chunk) whose registration
    takes ``reg_params`` (None: a call that registers nothing): cached under
    ``key`` (with :func:`knob_key`), the brute-force and the grid search
    alike; eager, made for the call, under ``LOAM_DEBUG_NANS=1``, which
    reads values on the host by design."""
    if debug_nans_enabled():
        return program.Program(dev, inputs, capturable=False)
    return program.cached(dev, key + (reg_params, program.signature(inputs), knob_key()), inputs,
                          **info)


def _angle_from_identity(q: torch.Tensor) -> torch.Tensor:
    """Rotation angle of a unit quaternion (Eigen ``angularDistance`` to I)."""
    return 2.0 * torch.atan2(norm(q[..., 1:]), torch.abs(q[..., 0]))


class _Loop:
    """One registration's loop: its carry in tensors of its own and
    :meth:`step` over them, reading the call's tensors where they lie.

    ``source``: the source ``(edge_points, edge_mask, planar_points,
    planar_mask)``; ``init``: the (B,) starting poses. ``search`` is the
    path's search state: ``(edge_prep, planar_prep)`` (``single``,
    ``preps``), ``(dual_prep,)`` (``dual``), ``(edge_grid, planar_grid)``
    (``grid``) or ``(edge_fn, planar_fn, seed_windows)`` (``custom``;
    ``sharded``, whose windows are None). ``target``: the target's
    ``(edge_points, edge_mask, planar_points, planar_mask)`` where the fits
    may gather neighbours by index (``dual``, ``grid``, ``custom``,
    ``sharded``), else None."""

    def __init__(self, path, params, with_matches, kernel_seed, source, init: Pose3, search, target):
        self.path, self.params, self.kernel_seed = path, params, kernel_seed
        self.src, self.init, self.search, self.target = source, init, search, target
        dtype, dev = source[0].dtype, source[0].device
        self.B, self.E = source[1].shape
        self.Q = source[3].shape[1]
        B, I = self.B, params.max_iterations
        Em, Qm = (self.E, self.Q) if with_matches else (0, 0)
        f = dict(dtype=dtype, device=dev)
        i32 = dict(dtype=torch.int32, device=dev)
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
        # search; its coordinates in the targets' dtype, which the search
        # rounds the queries to), or the 3-element custom_knn's neighbours
        kE, kP = params.num_edge_neighbors, params.num_plane_neighbors

        def packed(k, n):
            return PackedKnn(torch.empty((B, n), **i32), torch.empty((B, k, n), dtype=torch.bool, device=dev),
                             *(torch.empty((B, k, n), dtype=search[0].tT.dtype, device=dev)
                               for _ in range(3)))

        self.prev = (packed(kE, self.E), packed(kP, self.Q)) if kernel_seed else None
        self.seeds = None
        if path == "custom" and search[2] is not None:
            self.seeds = tuple((*(torch.empty((B, k, n), **f) for _ in range(3)),
                                torch.empty((B, k, n), dtype=torch.bool, device=dev))
                               for k, n in ((kE, self.E), (kP, self.Q)))

    def reset(self) -> None:
        """The carry at the loop's start: the estimate at ``init``, no
        iteration, every pair running, the detail rows empty."""
        self.est.rotation.copy_(self.init.rotation)
        self.est.translation.copy_(self.init.translation)
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
        if self.path in ("custom", "sharded"):
            edge_knn, plane_knn, windows = self.search
            if windows is None:
                return edge_knn(qe), plane_knn(qp), None, None
            # the kernel's visit gates: min(warm start at the moved queries,
            # cold start); they prune visits and change no output
            (ew, pw), (es, ps) = windows, self.seeds
            eb = torch.minimum(seed_bound_from_packed(qe, *es), seed_bound_from_window(qe, *ew, kE))
            pb = torch.minimum(seed_bound_from_packed(qp, *ps), seed_bound_from_window(qp, *pw, kP))
            e_res, p_res = edge_knn(qe, eb), plane_knn(qp, pb)
            program.copy_into(es, (e_res.xs, e_res.ys, e_res.zs, e_res.mask))
            program.copy_into(ps, (p_res.xs, p_res.ys, p_res.zs, p_res.mask))
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
            program.copy_into(self.prev, (e_res, p_res))
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
        ITERATIONS.add()

    def schedule(self) -> None:
        """``lax.while_loop`` from the start: the carry reset, the first
        iteration, then the later ones under
        ``program.while_loop(any_running)``, which holds ``it <
        max_iterations`` (eagerly a host loop that stops at the first false
        flag; in a capture one WHILE node)."""
        self.reset()
        if self.B == 0 or self.params.max_iterations == 0:
            return
        with torch.profiler.record_function(LOOP_RANGE):
            self.step(True)
            if self.params.max_iterations > 1:
                program.while_loop(self.any_running, lambda: self.step(False))

    def results(self):
        """``(est, status, it, detail)``: the carry's own tensors."""
        return self.est, self.status, self.it, self.detail
