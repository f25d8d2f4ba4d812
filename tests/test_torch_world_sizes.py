"""The mesh past four ranks, on the CPU: which counts the sharded entry
points take at a world size (rule 4), against ``loam_tpu`` on the
conftest's 8 CPU devices, and 8 gloo ranks on two hosts of four against one
rank of 8 shards and ``loam_tpu``'s 8-device twin.

Rule 4. ``loam_tpu`` places a sharded call's inputs with
``jax.device_put(x, NamedSharding(mesh, P("data", ...)))``
(``loam_tpu/parallel/sharding.py``: frames over "data" and scan lines over
"line" in extraction and offline odometry, pairs over "data" in pair
registration), which refuses a leading axis that the mesh axis does not
divide and splits one it divides into equal blocks; its sharded scan-to-map
refuses map capacities, and its pose graph edge counts, that the axis does
not divide. The port refuses the same counts with a ``ValueError`` before
any work, and splits the others into the same blocks: a shard's block of
``count / data`` items, as ``loam_tpu``'s shard holds. So a mesh of 24
ranks takes 24, 48, ... frames, pairs and map slots, and
``chip_smoke.py``'s cells at 24 ranks take such counts (``_counts``).

8 gloo ranks (``tests/test_torch_multiprocess.py``'s harness, mode
``many``), ``make_mesh(hosts=[0] * 4 + [1] * 4)``: the islands the labels
make, and the pose graph, six scan-to-map frames and offline odometry over 8
frames bit-equal to every other rank and to 1 rank x 8 shards (the fixed
order of the sum, a data row's block of pairs registered on its own:
``sharding._per_row``), each held to its single-device run as the harness
holds it; the offline trajectory also within ``loam_tpu``'s float32
tolerance, 1e-2 m / 1e-3 of a quaternion component (F6,
``test_torch_parallel.py``), of ``loam_tpu``'s ``odometry_offline_sharded``
on its 8 devices.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import loam_tpu as J
import loam_tpu.parallel as jpar
from loam_tpu.odometry import scan_to_map as j_s2m
from loam_tpu.parallel import distributed as jdist
from loam_tpu.pose_graph import PoseGraphEdges as JEdges, optimize_pose_graph_sharded as j_opt_sharded

import loam_tpu_torch as T
from loam_tpu_torch import parallel
from loam_tpu_torch.io import random_pose_graph, render_trajectory
from loam_tpu_torch.params import from_reference
from loam_tpu_torch.parallel import distributed as tdist
from loam_tpu_torch.pose_graph import optimize_pose_graph_sharded

torch.set_num_threads(1)

LIDAR = J.LidarParams(8, 128, 0.5, 80.0)
FEAT = J.FeatureExtractionParams(number_sectors=2)
REG = J.RegistrationParams(max_iterations=2, min_associations=10)
POS_TOL, ROT_TOL = 1e-2, 1e-3  # float32 port vs loam_tpu (F6)
COUNTS = (4, 6, 8, 12, 16, 20, 24)


def _jax_block(n: int, spec, mesh, rest=(1,)):
    """``loam_tpu``'s placement of ``n`` items (``device_put`` with
    ``spec``, as its sharded entry points place their inputs): a shard's
    items, or None where it refuses them."""
    try:
        x = jax.device_put(np.zeros((n,) + rest, np.float32), NamedSharding(mesh, spec))
    except ValueError:
        return None
    return x.sharding.shard_shape(x.shape)


def _raises(fn) -> bool:
    try:
        fn()
    except ValueError:
        return True
    return False


@pytest.mark.parametrize("n", COUNTS)
@pytest.mark.parametrize("what", ["frames", "pairs"])
def test_rule4_frames_and_pairs_follow_loam_tpu(what, n):
    """Frames (extraction, offline odometry) and pairs over a data axis of
    8: the port refuses exactly the counts ``loam_tpu`` refuses, before any
    work, and splits the others into ``loam_tpu``'s blocks."""
    jmesh, mesh = jpar.make_mesh(), parallel.make_mesh(["cpu"] * 8)
    lidar, feat, reg = from_reference(LIDAR), from_reference(FEAT), from_reference(REG)
    if what == "frames":
        want = _jax_block(n, P("data", "line"), jmesh, (8, 1))
        scans = np.zeros((n, 8, 128, 3), np.float32)
        twins = [lambda: jpar.extract_features_sharded(scans, LIDAR, jmesh, FEAT),
                 lambda: jpar.odometry_offline_sharded(scans, LIDAR, jmesh, FEAT, REG)]
        ports = [lambda: parallel.extract_features_sharded(scans, lidar, mesh, feat),
                 lambda: parallel.odometry_offline_sharded(scans, lidar, mesh, feat, reg)]
    else:  # register_pairs_sharded places every leaf with P("data")
        want = _jax_block(n, P("data"), jmesh)
        feats = T.extract_features_batch(torch.zeros((1, 8, 128, 3)), lidar, feat)
        feats = feats.map(lambda x: x.expand((n,) + x.shape[1:]))
        twins = []
        ports = [lambda: parallel.register_pairs_sharded(feats, feats, T.Pose3.identity(torch.float32, (n,)), mesh,
                                                         reg)]
    # the port's rule: the block of items a shard (a data row) takes
    got = None if _raises(lambda: parallel.sharding._blocks(n, what, mesh)) else n // mesh.shape["data"]
    assert (got is None) == (want is None) == bool(n % 8), (what, n, got, want)
    if want is None:  # every entry point of both refuses it, before any work
        assert all(_raises(f) for f in twins) and all(_raises(f) for f in ports), (what, n)
    else:
        assert got == want[0], (what, n, got, want)


@pytest.mark.parametrize("lines,line_axis", [(8, 2), (6, 2), (6, 4), (8, 8)])
def test_rule4_scan_lines_follow_loam_tpu(lines, line_axis):
    """Scan lines over the line axis: the port's extraction refuses a line
    count ``loam_tpu``'s placement refuses and splits the others alike."""
    devices = jax.devices()[:line_axis * (8 // line_axis)]
    jmesh = jpar.make_mesh(devices, line_axis=line_axis)
    mesh = parallel.make_mesh(["cpu"] * len(devices), line_axis=line_axis)
    data = mesh.shape["data"]
    want = _jax_block(data, P("data", "line"), jmesh, (lines, 1, 1))
    lidar = J.LidarParams(lines, 128, 0.5, 80.0)
    scans = np.zeros((data, lines, 128, 3), np.float32)
    if want is None:
        assert _raises(lambda: jpar.extract_features_sharded(scans, lidar, jmesh, FEAT))
        assert _raises(lambda: parallel.extract_features_sharded(scans, from_reference(lidar), mesh,
                                                                 from_reference(FEAT)))
    else:
        feats = parallel.extract_features_sharded(scans, from_reference(lidar), mesh, from_reference(FEAT))
        assert feats.edge_mask.shape[0] == data and want[1] == lines // line_axis


@pytest.mark.parametrize("n", COUNTS)
def test_rule4_map_slots_and_edges_follow_loam_tpu(n):
    """Map capacities and pose-graph edges over a data axis of 8: both
    packages refuse the same counts."""
    jmesh, mesh = jpar.make_mesh(), parallel.make_mesh(["cpu"] * 8)
    cap = 1024 + n  # edge slots; the planar map's 4,096 split
    jrefused = _raises(lambda: jdist.scan_to_map_init_sharded(
        j_s2m.ScanToMapConfig(edge_capacity=cap, planar_capacity=4096), jmesh))
    assert _raises(lambda: tdist.scan_to_map_init_sharded(
        T.ScanToMapConfig(edge_capacity=cap, planar_capacity=4096), mesh)) == jrefused == bool(n % 8)
    _, init, edges = random_pose_graph(n + 1, 0, seed=0)  # n edges, a chain
    jp = lambda p: J.Pose3(jnp.asarray(p.rotation.numpy()), jnp.asarray(p.translation.numpy()))
    jedges = JEdges(jnp.asarray(edges.i.numpy()), jnp.asarray(edges.j.numpy()), jp(edges.measurement),
                    jnp.asarray(edges.weight.numpy()), jnp.asarray(edges.mask.numpy()))
    try:
        jax.jit(lambda i, e: j_opt_sharded(i, e, jmesh, iterations=1)).lower(jp(init), jedges)
        jrefused = False
    except ValueError:
        jrefused = True
    assert _raises(lambda: optimize_pose_graph_sharded(init, edges, mesh, iterations=1)) == jrefused == bool(n % 8)


def test_eight_gloo_ranks_on_two_hosts(tmp_path):
    """8 gloo ranks, ``make_mesh(hosts=[0] * 4 + [1] * 4)``: islands of the
    first four and the last four ranks on every rank; the pose graph, six
    scan-to-map frames and offline odometry bit-equal to every other rank
    and to 1 rank x 8 shards (the harness, mode ``many``); the offline
    trajectory within F6's tolerance of ``loam_tpu``'s 8-device twin."""
    from test_torch_multiprocess import _bit_equal_to_one_rank

    ranks = _bit_equal_to_one_rank("many", tmp_path, world=8, hosts="0,0,0,0,1,1,1,1")
    for res in ranks:
        assert res["islands"].tolist() == [0] * 4 + [1] * 4
    scans, _ = render_trajectory(from_reference(LIDAR), 8, step=np.array([0.05, 0.0, 0.0]), noise=0.003, seed=5,
                                 dtype=np.float32)
    jt, _ = jpar.odometry_offline_sharded(jnp.asarray(scans), LIDAR, jpar.make_mesh(), FEAT, REG)
    np.testing.assert_allclose(ranks[0]["offline.t"], np.asarray(jt.translation), atol=POS_TOL, rtol=0)
    np.testing.assert_allclose(ranks[0]["offline.q"], np.asarray(jt.rotation), atol=ROT_TOL, rtol=0)
