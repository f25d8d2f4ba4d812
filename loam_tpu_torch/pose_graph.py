"""Pose-graph optimization (SE(3) Levenberg-Marquardt) on torch tensors.

Counterpart of ``loam_tpu.pose_graph``: given relative-pose constraints --
sequential odometry edges plus loop closures -- refine the whole trajectory,
the layer above odometry that the reference leaves to its users.

All E edges are processed at once: the residuals and their (6, 6) Jacobian
blocks of the exact quaternion residual (``loam_tpu`` differentiates it with
``jax.jacfwd`` under ``jax.vmap``; here the blocks are in closed form, see
``_edge_jacobians``) are scatter-added into dense 6N x 6N normal equations
and solved by Cholesky with Levenberg-Marquardt damping.
Edges carry a validity mask, so an edge set can be padded to a fixed
capacity; node 0 is the gauge.

The loop runs a fixed number of iterations with no host sync: the Cholesky
is ``torch.linalg.cholesky_ex``, whose failure flag joins the accept test
instead of raising (``loam_tpu``'s Cholesky returns NaNs there, which the
accept test rejects alike), and accept/reject is a ``torch.where``. A
solve is one program (``program.py``), as ``loam_tpu`` jits
``optimize_pose_graph``: the iterations a ``program.scan`` over the carry
``(poses, lam, cost)``, ``loam_tpu``'s ``lax.scan(length=iterations)``;
eager on the CPU, one CUDA-graph launch on the card with the iterations
under one WHILE node, whose nodes do not depend on ``iterations``. The
factorisation is cuSOLVER's ``potrf`` (``cholesky_ex``: PyTorch takes it for
one matrix, with no host read) and the solve two cuBLAS triangular solves
(``solve_triangular``): cuSOLVER's ``potrs`` (``cholesky_solve``) is
refused inside a CUDA-graph WHILE body, where ``potrf`` and ``trsm`` are
not. ``loam_tpu`` leaves the same work to XLA's library. The sharded solve
is one program too, its sums over the mesh inside the WHILE node.

Assembly uses ``index_put_(accumulate=True)``. On a CUDA tensor PyTorch
sorts the indices (a stable radix sort) and adds each entry's terms in that
order, so a solve repeats bit for bit on the card, through its graph and
eagerly alike; the order is not the CPU's, so a diagonal block of a node with
three or more edges, and the gradient, may differ from the CPU's in their
last bits (two terms added to zero are exact in either order), and the
solution by that rounding only.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from . import program
from .device import place
from .geometry import (
    Pose3,
    quat_conjugate,
    quat_exp,
    quat_log,
    quat_multiply,
    quat_normalize,
    quat_rotate,
    quat_to_matrix,
)


class PoseGraphEdges(NamedTuple):
    """Relative-pose constraints; every leaf leads with E.

    ``measurement`` is the expected ``node_i_T_node_j``; ``weight`` scales
    each edge's contribution (e.g. inverse variance); invalid slots are
    masked out.
    """

    i: torch.Tensor  # (E,) int32 source node
    j: torch.Tensor  # (E,) int32 target node
    measurement: Pose3  # (E, ...) leaves
    weight: torch.Tensor  # (E,)
    mask: torch.Tensor  # (E,) bool


def make_edges(i, j, measurement: Pose3, weight=None, mask=None) -> PoseGraphEdges:
    """Edges from node indices, measurements and optional weights / mask;
    array-likes go to the measurement's device."""
    dev = measurement.translation.device
    i = place(i, dev, torch.int32)
    if weight is None:
        weight = torch.ones(i.shape, dtype=measurement.translation.dtype, device=dev)
    if mask is None:
        mask = torch.ones(i.shape, dtype=torch.bool, device=dev)
    return PoseGraphEdges(i, place(j, dev, torch.int32), measurement,
                          place(weight, dev), place(mask, dev, torch.bool))


def odometry_edges(trajectory: Pose3) -> PoseGraphEdges:
    """Sequential edges from a trajectory of world poses: the odometry chain
    ``i -> i+1`` with measurement ``T_i^-1 T_{i+1}``."""
    q, t = trajectory
    inv = quat_conjugate(q[:-1])
    rel = Pose3(quat_multiply(inv, q[1:]), quat_rotate(inv, t[1:] - t[:-1]))
    n = t.shape[0]
    ar = torch.arange(n, dtype=torch.int32, device=t.device)
    return make_edges(ar[:-1], ar[1:], rel)


def _edge_residual(xi_i, xi_j, Ti: Pose3, Tj: Pose3, z: Pose3) -> torch.Tensor:
    """``r = Log(z^-1 (Exp(xi_i) Ti)^-1 (Exp(xi_j) Tj))`` in R^6, rotation
    part first; leading axes batch. Evaluated at ``xi = 0`` in the solver,
    where autodiff gives the exact (6, 6) Jacobian blocks."""
    qi, qj = quat_exp(xi_i[..., :3]), quat_exp(xi_j[..., :3])
    Pi = Pose3(quat_multiply(qi, Ti.rotation), quat_rotate(qi, Ti.translation) + xi_i[..., 3:])
    Pj = Pose3(quat_multiply(qj, Tj.rotation), quat_rotate(qj, Tj.translation) + xi_j[..., 3:])
    err = z.inverse().compose(Pi.inverse().compose(Pj))
    return torch.cat([quat_log(err.rotation), err.translation], dim=-1)


def _skew(v: torch.Tensor) -> torch.Tensor:
    """``[v]x`` (..., 3, 3) of vectors (..., 3): ``[v]x w = v x w``."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    o = torch.zeros_like(x)
    return torch.stack([o, -z, y, z, o, -x, -y, x, o], dim=-1).reshape(v.shape + (3,))


def _edge_jacobians(qi, ti, qj, tj, zq, zt):
    """``(Ji, Jj), r`` of every edge at ``xi = 0``: the (E, 6, 6) blocks and
    the (E, 6) residuals, the blocks in closed form.

    With ``Ti = (qi, ti)`` perturbed on the left by ``xi_i = (w_i, v_i)``, the
    residual's rotation is ``Log(q0 Exp(Rj^T (w_j - w_i)))`` to first order
    (``q0`` the residual quaternion at ``xi = 0``) and its translation is
    ``Rz^T (Ri^T (Exp(w_i)^T (Exp(w_j) tj + v_j - v_i) - ti) - zt)``, so with
    ``M = Rz^T Ri^T`` and ``Jr^-1`` the inverse right Jacobian of SO(3) at
    the residual rotation ``theta``::

        Jj = [[ Jr^-1 Rj^T, 0], [-M [tj]x,  M]]
        Ji = [[-Jr^-1 Rj^T, 0], [ M [tj]x, -M]]

    ``Jr^-1 = I + [theta]x / 2 + c [theta]x^2``, ``c = 1 / theta^2 -
    (1 + cos theta) / (2 theta sin theta)``, which is ``1/12 + theta^2 / 720``
    to float64 rounding below ``theta = 1e-4`` (there, at a residual of zero,
    ``Jr^-1 = I``). These equal ``jax.jacfwd`` of ``loam_tpu``'s residual
    (held by the tests). Forward-mode autodiff in PyTorch gives them too, but
    ``torch.func.jacfwd`` under ``vmap`` and dual tensors alike run each
    multiplication through a Python decomposition: ~0.1 s of host time a
    call at 40 edges as at 1,049, which made a 10-iteration solve take 1.0 s
    on an H100 machine.
    """
    zero = torch.zeros_like(ti[..., :1]).expand(ti.shape[:-1] + (6,))
    r = _edge_residual(zero, zero, Pose3(qi, ti), Pose3(qj, tj), Pose3(zq, zt))
    theta = r[..., :3]
    t2 = torch.sum(theta * theta, dim=-1)[..., None, None]
    small = t2 < 1e-8
    t2s = torch.where(small, torch.ones_like(t2), t2)
    th = torch.sqrt(t2s)
    c = torch.where(small, 1.0 / 12.0 + t2 / 720.0,
                    1.0 / t2s - (1.0 + torch.cos(th)) / (2.0 * th * torch.sin(th)))
    K = _skew(theta)
    eye = torch.eye(3, dtype=ti.dtype, device=ti.device)
    A = (eye + 0.5 * K + c * (K @ K)) @ quat_to_matrix(qj).transpose(-1, -2)
    M = quat_to_matrix(zq).transpose(-1, -2) @ quat_to_matrix(qi).transpose(-1, -2)
    B = M @ _skew(tj)
    O = torch.zeros_like(M)
    Jj = torch.cat([torch.cat([A, O], dim=-1), torch.cat([-B, M], dim=-1)], dim=-2)
    Ji = torch.cat([torch.cat([-A, O], dim=-1), torch.cat([B, -M], dim=-1)], dim=-2)
    return (Ji, Jj), r


def _endpoints(poses: Pose3, edges: PoseGraphEdges):
    ii, jj = edges.i.long(), edges.j.long()
    return (poses.rotation[ii], poses.translation[ii], poses.rotation[jj],
            poses.translation[jj], edges.measurement.rotation, edges.measurement.translation)


def _weights(edges: PoseGraphEdges) -> torch.Tensor:
    return torch.where(edges.mask, edges.weight, torch.zeros_like(edges.weight))


def _cost(poses: Pose3, edges: PoseGraphEdges) -> torch.Tensor:
    """Total weighted squared residual (no Jacobians)."""
    qi, ti, qj, tj, zq, zt = _endpoints(poses, edges)
    zero = torch.zeros_like(ti[..., :1]).expand(ti.shape[:-1] + (6,))
    r = _edge_residual(zero, zero, Pose3(qi, ti), Pose3(qj, tj), Pose3(zq, zt))
    return torch.sum(_weights(edges) * torch.sum(r * r, dim=-1))


def _assemble(poses: Pose3, edges: PoseGraphEdges, dim: int):
    """Dense normal equations ``H`` (dim, dim), gradient ``b`` (dim,)."""
    dtype, dev = poses.translation.dtype, poses.translation.device
    (Ji, Jj), r = _edge_jacobians(*_endpoints(poses, edges))
    w = _weights(edges)
    wj = w[:, None, None]
    Hii = wj * torch.einsum("eri,erj->eij", Ji, Ji)
    Hjj = wj * torch.einsum("eri,erj->eij", Jj, Jj)
    Hij = wj * torch.einsum("eri,erj->eij", Ji, Jj)
    bi = w[:, None] * torch.einsum("eri,er->ei", Ji, r)
    bj = w[:, None] * torch.einsum("eri,er->ei", Jj, r)
    six = torch.arange(6, device=dev)
    oi = (6 * edges.i.long())[:, None] + six  # (E, 6)
    oj = (6 * edges.j.long())[:, None] + six
    H = torch.zeros((dim, dim), dtype=dtype, device=dev)
    for rows, cols, blk in ((oi, oi, Hii), (oj, oj, Hjj), (oi, oj, Hij),
                            (oj, oi, Hij.transpose(-1, -2))):
        H.index_put_((rows[:, :, None].expand(blk.shape), cols[:, None, :].expand(blk.shape)),
                     blk, accumulate=True)
    b = torch.zeros(dim, dtype=dtype, device=dev)
    b.index_put_((oi,), bi, accumulate=True)
    b.index_put_((oj,), bj, accumulate=True)
    return H, b


def _apply_update(poses: Pose3, dx: torch.Tensor) -> Pose3:
    xi = dx.reshape(-1, 6).clone()
    xi[0].zero_()  # gauge
    dq = quat_exp(xi[:, :3])
    return Pose3(quat_normalize(quat_multiply(dq, poses.rotation)),
                 quat_rotate(dq, poses.translation) + xi[:, 3:])


def _cast(initial: Pose3, edges: PoseGraphEdges):
    """Poses and edge measurements / weights in the dtype of ``initial``'s
    translations."""
    dtype = initial.translation.dtype
    poses = Pose3(initial.rotation.to(dtype), initial.translation.to(dtype))
    z = edges.measurement
    edges = edges._replace(measurement=Pose3(z.rotation.to(dtype), z.translation.to(dtype)),
                           weight=edges.weight.to(dtype))
    return poses, edges


def _levenberg_marquardt(poses: Pose3, iterations: int, assemble, cost):
    """The LM loop over ``assemble(poses) -> (H, b)`` and ``cost(poses)``:
    ``iterations`` damped Cholesky steps, each kept only if it lowers the
    cost, as ``program.scan`` over the carry ``(poses, lam, cost)`` -- a
    host loop eagerly, one WHILE node in a capture -- with no host read.
    The carry lives in buffers made before the scan and is updated in
    place; nothing inside copies from the host."""
    dtype, dev = poses.translation.dtype, poses.translation.device
    dim = 6 * poses.translation.shape[0]
    gauge = torch.zeros(dim, dtype=dtype, device=dev)
    gauge[:6].fill_(1e12)  # clamp node 0
    poses = Pose3(poses.rotation.clone(), poses.translation.clone())
    lam = torch.full((), 1e-6, dtype=dtype, device=dev)
    c = cost(poses)

    def step(i):
        H, b = assemble(poses)
        diag = H.diagonal()
        diag.add_(lam * diag + 1e-8 + gauge)
        L, info = torch.linalg.cholesky_ex(H)
        del H, diag
        # L L^T dx = -b as two triangular solves (cuBLAS trsm): cuSOLVER's
        # potrs (``torch.cholesky_solve``) cannot be captured into a WHILE body
        y = torch.linalg.solve_triangular(L, b[:, None], upper=False)
        dx = -torch.linalg.solve_triangular(L.mT, y, upper=True)[:, 0]
        del L, y
        candidate = _apply_update(poses, dx)
        new_cost = cost(candidate)
        accept = (new_cost < c) & (info == 0)
        program.copy_into(poses, Pose3(torch.where(accept, candidate.rotation, poses.rotation),
                                       torch.where(accept, candidate.translation, poses.translation)))
        lam.copy_(torch.where(accept, torch.clamp(lam / 3.0, min=1e-12), torch.clamp(lam * 4.0, max=1e8)))
        c.copy_(torch.where(accept, new_cost, c))

    program.scan(iterations, step, dev)
    return poses, c


def _solve(initial: Pose3, edges: PoseGraphEdges, iterations: int) -> Tuple[Pose3, torch.Tensor]:
    """:func:`optimize_pose_graph`'s work on its program's buffers."""
    poses, edges = _cast(initial, edges)
    dim = 6 * poses.translation.shape[0]
    return _levenberg_marquardt(poses, iterations, lambda p: _assemble(p, edges, dim),
                                lambda p: _cost(p, edges))


def optimize_pose_graph(
    initial: Pose3,
    edges: PoseGraphEdges,
    iterations: int = 10,
) -> Tuple[Pose3, torch.Tensor]:
    """Gauss-Newton/LM pose-graph solve on the device of ``initial``.

    One program a call (``program.py``), cached on the device, the node and
    edge counts, the dtypes and ``iterations``: eager on the CPU, one
    CUDA-graph launch on the card. Inside another program (the loop-closed
    call) it runs inline.

    Args:
      initial: (N, ...) world poses (node 0 is the fixed gauge).
      edges: padded constraint set.
      iterations: outer LM iterations, all of them run.

    Returns: (optimized trajectory, final total weighted squared error).
    """
    inputs = (initial, edges)
    if program.nested():
        return _solve(initial, edges, iterations)
    dev = initial.translation.device
    prog = program.cached(dev, ("pose_graph", iterations, program.signature(inputs)), inputs,
                          path="pose_graph", nodes=initial.translation.shape[0], edges=edges.i.shape[0],
                          dtype=str(initial.translation.dtype), iterations=iterations)
    with torch.profiler.record_function(program.DRIVER_RANGE):
        return prog.own(prog.run(lambda b: _solve(*b, iterations), inputs))


def optimize_pose_graph_sharded(
    initial: Pose3,
    edges: PoseGraphEdges,
    mesh,
    iterations: int = 10,
    axis: str = "data",
) -> Tuple[Pose3, torch.Tensor]:
    """Distributed pose-graph solve: the edges sharded over ``axis`` of
    ``mesh`` (``parallel.make_mesh``), ``loam_tpu``'s
    ``optimize_pose_graph_sharded``.

    ``initial`` and ``edges`` are replicated: every rank passes the whole
    graph. Each shard assembles the normal equations and the cost of its
    contiguous block of edges (shard g holds edges ``g*E/D .. (g+1)*E/D - 1``)
    into a stack made before the LM loop; ``parallel.collectives.sum`` adds
    the partials in global shard order, so every rank holds the same system
    bit for bit, and the LM loop of :func:`optimize_pose_graph` runs
    replicated on it. Results match the single-device solve up to the order
    of the additions. The edge count must be a multiple of the shard count:
    pad with masked edges. One program a call (``sharding.run_program``,
    keyed on the mesh's token): on the card one CUDA-graph launch, the
    shards' assemblies and the sums' gathers inside the LM loop's WHILE
    node, at every world size; eager on the CPU and over gloo. A rank's
    shards assemble, and cost, side by side (``program.branches``: on the
    card a stream each, at once, inside the WHILE node), each with the
    launches of a rank that holds that shard alone, its system copied into
    its row of the stack; the sums come after them.
    """
    from .parallel import collectives
    from .parallel.sharding import run_program
    from .registration.detail import tree_map

    D, mine = mesh.shards_along(axis)
    E = edges.i.shape[0]
    if E % D:
        raise ValueError(f"{E} edges do not split evenly over the {D} shards of mesh axis "
                         f"{axis!r}: pad with masked edges")
    to_mesh = lambda x: x.to(mesh.device)
    inputs = (tree_map(to_mesh, initial), tree_map(to_mesh, edges))
    n = E // D

    def solve(bufs):
        poses, edges = _cast(*bufs)
        dtype, dim = poses.translation.dtype, 6 * poses.translation.shape[0]
        blocks = [tree_map(lambda x, g=g: x[g * n:(g + 1) * n], edges) for g in mine]
        # the shards' partial systems, side by side, each copied into its row of the stack
        H = torch.empty((len(blocks), dim, dim), dtype=dtype, device=mesh.device)
        b = torch.empty((len(blocks), dim), dtype=dtype, device=mesh.device)

        def shard(p, s, e):
            H[s], b[s] = _assemble(p, e, dim)

        def assemble(p):
            program.branches([lambda s=s, e=e: shard(p, s, e) for s, e in enumerate(blocks)], mesh.device)
            return collectives.sum(mesh, H), collectives.sum(mesh, b)

        def cost(p):
            return collectives.sum(mesh, torch.stack(program.branches([lambda e=e: _cost(p, e) for e in blocks],
                                                                      mesh.device)))

        return _levenberg_marquardt(poses, iterations, assemble, cost)

    prog, out = run_program(mesh, ("pose_graph_sharded", axis, iterations), inputs, solve, None,
                            path="pose_graph_sharded", nodes=initial.translation.shape[0], edges=E,
                            dtype=str(initial.translation.dtype), iterations=iterations)
    return prog.own(out)
