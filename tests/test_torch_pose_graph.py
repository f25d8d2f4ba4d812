"""The port's pose-graph solver (``pose_graph.py``) against ``loam_tpu``'s on
the same numpy inputs, on the CPU, in float64.

Twins of ``test_pose_graph.py``'s exact-graph, drift and masked-edge cases:
the optimized poses agree within 1e-8 and the costs within rtol 1e-8 (both
solve the same normal equations; the two Cholesky factorizations and the
scatter-add order round differently). The port's closed-form (6, 6)
Jacobian blocks equal ``jax.jacfwd`` of ``loam_tpu.pose_graph._edge_residual``
within 1e-10: at exactly zero residuals, where the rotation logarithm takes
its small-angle branch, at small ones and at rotations of ~0.9 rad.

float32 (``test_float32_solve_tolerance``, ``io.random_pose_graph``: a chain
with closures, noise-free measurements, a perturbed start, 10 iterations):
float32's own rounding sets how close a solve comes to the truth, and the
two packages round differently (both factorise in float32: ``loam_tpu``
solves with ``cho_solve``, the port with two triangular solves, and their
sums run in other orders), so neither is the other's truth. The tolerance,
stated up to ~300 nodes, both ways:
the port's largest position error against the truth is at most
``loam_tpu``'s times ``F32_FACTOR`` (3) plus ``F32_FLOOR_M`` (5e-5 m), and
the port's poses are within ``F32_GAP_M`` (2e-3 m, ~4x ``loam_tpu``'s own
float32 error of 5.13e-4 m on the 300-node graph) and ``F32_GAP_Q`` (5e-5,
quaternion components) of ``loam_tpu``'s. The test prints both packages'
distances to the truth and their gap. Longer chains leave the solve to
float32 in both packages alike (``test_float32_solve_at_600_nodes``): at 600
nodes and 30 closures ``loam_tpu``'s float32 solve lands 4.7e-5 m (seed 0)
and 5.2e-3 m (seed 5) from the truth, the port's 1.3e-3 and 3.0e-3 m (one
CPU thread: the order of its sums, and so its float32 result, follows the
thread count), the float64 solve within 1e-10 m.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import loam_tpu.pose_graph as jpg
from loam_tpu.geometry import Pose3 as JPose3
from loam_tpu.geometry import quat_exp as j_quat_exp

import loam_tpu_torch.pose_graph as tpg
from loam_tpu_torch.geometry import Pose3, quat_exp, quat_multiply, quat_normalize
from loam_tpu_torch.io import random_pose_graph

torch.set_num_threads(1)

POSE_TOL, COST_RTOL, JAC_TOL = 1e-8, 1e-8, 1e-10
F32_FACTOR, F32_FLOOR_M, F32_GAP_M, F32_GAP_Q = 3.0, 5e-5, 2e-3, 5e-5
F32_FAR_M = 2e-2


def _square(n_per_side=5, step=1.0):
    """Ground-truth square loop in the plane (as ``test_pose_graph.py``), as
    numpy (rotation, translation)."""
    poses = [JPose3.identity(jnp.float64)]
    z = jnp.asarray([0.0, 0.0, 1.0])
    for _ in range(4):
        for _ in range(n_per_side):
            poses.append(poses[-1].compose(JPose3(j_quat_exp(jnp.zeros(3)),
                                                  jnp.asarray([step, 0.0, 0.0]))))
        poses.append(poses[-1].compose(JPose3(j_quat_exp(z * (np.pi / 2)), jnp.zeros(3))))
    return np.stack([np.asarray(p.rotation) for p in poses]), np.stack(
        [np.asarray(p.translation) for p in poses])


def _perturb(rot, trans, sigma_rot, sigma_t, seed):
    rng = np.random.default_rng(seed)
    dq = quat_exp(torch.from_numpy(rng.normal(0, sigma_rot, (len(rot), 3))))
    return (quat_normalize(quat_multiply(dq, torch.from_numpy(rot))).numpy(),
            trans + rng.normal(0, sigma_t, trans.shape))


def _edges_both(i, j, zq, zt, w=None, mask=None):
    jm = JPose3(jnp.asarray(zq), jnp.asarray(zt))
    tm = Pose3(torch.from_numpy(zq), torch.from_numpy(zt))
    je = jpg.make_edges(jnp.asarray(i), jnp.asarray(j), jm,
                        None if w is None else jnp.asarray(w),
                        None if mask is None else jnp.asarray(mask))
    te = tpg.make_edges(i, j, tm, None if w is None else torch.from_numpy(np.asarray(w)), mask)
    return je, te


def _solve_both(init, je, te, iterations):
    jo, jc = jpg.optimize_pose_graph(JPose3(jnp.asarray(init[0]), jnp.asarray(init[1])), je,
                                     iterations=iterations)
    to, tc = tpg.optimize_pose_graph(Pose3(torch.from_numpy(init[0]), torch.from_numpy(init[1])),
                                     te, iterations=iterations)
    np.testing.assert_allclose(to.translation.numpy(), np.asarray(jo.translation), atol=POSE_TOL, rtol=0)
    np.testing.assert_allclose(to.rotation.numpy(), np.asarray(jo.rotation), atol=POSE_TOL, rtol=0)
    np.testing.assert_allclose(float(tc), float(jc), rtol=COST_RTOL, atol=1e-20)
    return to, tc


def _odometry_edges_both(rot, trans):
    je = jpg.odometry_edges(JPose3(jnp.asarray(rot), jnp.asarray(trans)))
    te = tpg.odometry_edges(Pose3(torch.from_numpy(rot), torch.from_numpy(trans)))
    for a, b in zip(jax.tree.leaves(je), (te.i, te.j, *te.measurement, te.weight, te.mask)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-12, rtol=0)
    return je, te


def test_recovers_exact_graph():
    rot, trans = _square()
    je, te = _odometry_edges_both(rot, trans)
    rng = np.random.default_rng(1)
    N = len(rot)
    init_q = quat_normalize(quat_multiply(quat_exp(torch.from_numpy(rng.normal(0, 0.05, (N, 3)))),
                                          torch.from_numpy(rot))).numpy()
    init_t = trans + rng.normal(0, 0.3, (N, 3))
    init_q[0], init_t[0] = rot[0], trans[0]  # node 0 fixed
    opt, cost = _solve_both((init_q, init_t), je, te, 10)
    assert float(cost) < 1e-12
    np.testing.assert_allclose(opt.translation.numpy(), trans, atol=1e-5)


def test_loop_closure_corrects_drift():
    rot, trans = _square()
    N = len(rot)
    je, te = _odometry_edges_both(rot, trans)
    zq, zt = _perturb(te.measurement.rotation.numpy(), te.measurement.translation.numpy(),
                      0.004, 0.02, seed=2)
    # integrate the noisy chain as the initial guess
    poses = [Pose3.identity(torch.float64)]
    for e in range(N - 1):
        poses.append(poses[-1].compose(Pose3(torch.from_numpy(zq[e]), torch.from_numpy(zt[e]))))
    init = (torch.stack([p.rotation for p in poses]).numpy(),
            torch.stack([p.translation for p in poses]).numpy())
    # the last node sees node 0 exactly: z = T_{N-1}^-1 T_0
    last = Pose3(torch.from_numpy(rot[-1]), torch.from_numpy(trans[-1]))
    close = last.inverse().compose(Pose3(torch.from_numpy(rot[0]), torch.from_numpy(trans[0])))
    i = np.r_[np.arange(N - 1), N - 1]
    j = np.r_[np.arange(1, N), 0]
    je, te = _edges_both(i, j, np.concatenate([zq, close.rotation.numpy()[None]]),
                         np.concatenate([zt, close.translation.numpy()[None]]),
                         w=np.r_[np.ones(N - 1), 100.0])
    opt, _ = _solve_both(init, je, te, 15)
    drift0 = np.linalg.norm(init[1][-1] - trans[-1])
    drift1 = np.linalg.norm(opt.translation.numpy()[-1] - trans[-1])
    assert drift1 < 0.05 * max(drift0, 1e-9) or drift1 < 1e-3, (drift0, drift1)
    err0 = np.linalg.norm(init[1] - trans, axis=1).mean()
    err1 = np.linalg.norm(opt.translation.numpy() - trans, axis=1).mean()
    assert err1 < 0.5 * err0, (err0, err1)


def test_masked_edges_ignored():
    rot, trans = _square(n_per_side=2)
    N = len(rot)
    _, te = _odometry_edges_both(rot, trans)
    zq = np.concatenate([te.measurement.rotation.numpy(), [[1.0, 0, 0, 0]]])
    zt = np.concatenate([te.measurement.translation.numpy(), [[99.0, 0, 0]]])
    i, j = np.r_[np.arange(N - 1), 0], np.r_[np.arange(1, N), 3]
    je, te_b = _edges_both(i, j, zq, zt, mask=np.r_[np.ones(N - 1, bool), False])
    a, _ = tpg.optimize_pose_graph(Pose3(torch.from_numpy(rot), torch.from_numpy(trans)), te, 3)
    b, _ = _solve_both((rot, trans), je, te_b, 3)
    np.testing.assert_allclose(a.translation.numpy(), b.translation.numpy(), atol=1e-9)


@pytest.mark.parametrize("residual", ["zero", "nonzero", "large"])
def test_jacobian_blocks_match_jax(residual):
    """At a consistent edge (z = Ti^-1 Tj: residual zero, the logarithm's
    small-angle branch) and at noisy ones, the (6, 6) blocks and residuals
    equal ``jax.jacfwd`` of ``loam_tpu``'s residual."""
    rng = np.random.default_rng(7)
    E = 6
    qi = quat_normalize(torch.from_numpy(rng.normal(size=(E, 4)))).numpy()
    qj = quat_normalize(torch.from_numpy(rng.normal(size=(E, 4)))).numpy()
    ti, tj = rng.normal(size=(E, 3)) * 3, rng.normal(size=(E, 3)) * 3
    Ti, Tj = Pose3(torch.from_numpy(qi), torch.from_numpy(ti)), Pose3(torch.from_numpy(qj), torch.from_numpy(tj))
    z = Ti.inverse().compose(Tj)
    if residual != "zero":
        sigma = 0.05 if residual == "nonzero" else 0.5
        zq, zt = _perturb(z.rotation.numpy(), z.translation.numpy(), sigma, 0.1, seed=3)
    else:
        zq, zt = z.rotation.numpy(), z.translation.numpy()
    zero = np.zeros(6)
    (Ji, Jj), r = tpg._edge_jacobians(*(torch.from_numpy(x) for x in (qi, ti, qj, tj, zq, zt)))
    jf = lambda a, b, T1, T2, zz: jpg._edge_residual(a, b, T1, T2, zz)
    args = (jnp.asarray(zero), jnp.asarray(zero))
    leaves = tuple(JPose3(jnp.asarray(q), jnp.asarray(t)) for q, t in ((qi, ti), (qj, tj), (zq, zt)))
    ax = (None, None, 0, 0, 0)
    for got, fn in ((Ji, jax.jacfwd(jf, 0)), (Jj, jax.jacfwd(jf, 1)), (r, jf)):
        want = np.asarray(jax.vmap(fn, in_axes=ax)(*args, *leaves))
        assert np.isfinite(got.numpy()).all()
        np.testing.assert_allclose(got.numpy(), want, atol=JAC_TOL, rtol=0)
    if residual == "zero":
        assert np.abs(r.numpy()).max() < 1e-12


@pytest.mark.parametrize("nodes,closures", [(100, 10), (300, 20)], ids=["100_nodes", "300_nodes"])
def test_float32_solve_tolerance(nodes, closures):
    """The float32 solve against ``loam_tpu``'s float32 solve and the truth,
    at the tolerance of the module docstring; both costs fall."""
    gt, init, edges = random_pose_graph(nodes, closures, seed=0)
    f32 = lambda x: x.numpy().astype(np.float32)
    zq, zt, w = f32(edges.measurement.rotation), f32(edges.measurement.translation), f32(edges.weight)
    je, te = _edges_both(edges.i.numpy(), edges.j.numpy(), zq, zt, w=w, mask=edges.mask.numpy())
    q0, t0 = f32(init.rotation), f32(init.translation)
    jo, jc = jpg.optimize_pose_graph(JPose3(jnp.asarray(q0), jnp.asarray(t0)), je, iterations=10)
    to, tc = tpg.optimize_pose_graph(Pose3(torch.from_numpy(q0), torch.from_numpy(t0)), te, iterations=10)
    assert to.translation.dtype == torch.float32
    cost0 = float(tpg._cost(Pose3(torch.from_numpy(q0), torch.from_numpy(t0)), te))
    assert float(tc) < cost0 and float(jc) < cost0
    truth = gt.translation.numpy()
    port_t, ref_t = to.translation.numpy().astype(np.float64), np.asarray(jo.translation, np.float64)
    err_port, err_ref = np.abs(port_t - truth).max(), np.abs(ref_t - truth).max()
    gap_t = np.abs(port_t - ref_t).max()
    gap_q = np.abs(to.rotation.numpy().astype(np.float64) - np.asarray(jo.rotation, np.float64)).max()
    print(f"{nodes} nodes float32: from the truth port {err_port:.3e} m, loam_tpu {err_ref:.3e} m; "
          f"port vs loam_tpu {gap_t:.3e} m, {gap_q:.3e} (quaternion)")
    assert err_port <= F32_FACTOR * err_ref + F32_FLOOR_M, (err_port, err_ref)
    assert gap_t <= F32_GAP_M and gap_q <= F32_GAP_Q, (gap_t, gap_q)


@pytest.mark.parametrize("seed", [0, 5])
def test_float32_solve_at_600_nodes(seed):
    """A 600-node chain with 30 closures, past the float32 tolerance's
    ~300 nodes: float32 sets the error in both packages (module
    docstring), each package's distance to the truth scattering either way
    of the other's by several times, up to ~1e-2 m; the float64 solve lands
    within 1e-9 m. Held: both float32 solves lower the cost and land within
    ``F32_FAR_M`` (2e-2 m) of the truth, the float64 solve within 1e-9 m;
    the test prints the distances."""
    gt, init, edges = random_pose_graph(600, 30, seed=seed)
    f32 = lambda x: x.numpy().astype(np.float32)
    zq, zt, w = f32(edges.measurement.rotation), f32(edges.measurement.translation), f32(edges.weight)
    je, te = _edges_both(edges.i.numpy(), edges.j.numpy(), zq, zt, w=w, mask=edges.mask.numpy())
    q0, t0 = f32(init.rotation), f32(init.translation)
    jo, jc = jpg.optimize_pose_graph(JPose3(jnp.asarray(q0), jnp.asarray(t0)), je, iterations=10)
    to, tc = tpg.optimize_pose_graph(Pose3(torch.from_numpy(q0), torch.from_numpy(t0)), te, iterations=10)
    o64, _ = tpg.optimize_pose_graph(init, edges, iterations=10)
    cost0 = float(tpg._cost(Pose3(torch.from_numpy(q0), torch.from_numpy(t0)), te))
    assert float(tc) < cost0 and float(jc) < cost0
    truth = gt.translation.numpy()
    err_port = np.abs(to.translation.numpy().astype(np.float64) - truth).max()
    err_ref = np.abs(np.asarray(jo.translation, np.float64) - truth).max()
    err64 = np.abs(o64.translation.numpy() - truth).max()
    print(f"600 nodes, seed {seed}: float32 from the truth port {err_port:.3e} m, loam_tpu {err_ref:.3e} m; "
          f"float64 port {err64:.3e} m")
    assert err_port <= F32_FAR_M and err_ref <= F32_FAR_M and err64 <= 1e-9, (err_port, err_ref, err64)
