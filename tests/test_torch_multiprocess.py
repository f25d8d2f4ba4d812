"""The port's mesh across processes: ranks of a gloo group on the CPU, the
twin of ``test_multiprocess.py``.

Each test starts two or four processes running this file as a script,

    python tests/test_torch_multiprocess.py <rank> <world> <port> <mode> <out_dir>

which join a ``torch.distributed`` gloo group over 127.0.0.1, build a mesh of
their shards (``make_mesh(["cpu"] * shards, group=...)``), run the mode's
sharded path, check it against the rank's own single-device run, and write
the result to ``<out_dir>/rank<r>.npz``. The script imports no JAX and runs
on the CPU.

  * ``pose_graph``: 2 ranks x 2 shards and 4 ranks x 1,
    ``optimize_pose_graph_sharded`` on a 60-node graph padded with masked
    edges to a multiple of 4; within 1e-8 of ``optimize_pose_graph``.
  * ``scan_to_map``: 2 ranks x 1 shard and 4 x 1,
    ``scan_to_map_step_sharded`` over 6 frames of ``test_multiprocess.py``'s
    8x256 scans; the keyframe decision equal every frame and poses within
    1e-5 (m, and quaternion components) of the rank's single-device step
    fed the same azimuth-sorted features (``scan_to_map_step_features``:
    the same neighbours and fits; equidistant map points may come in
    another order). The sharded step sorts its source by azimuth, as
    ``loam_tpu``'s does, where ``scan_to_map_step`` sorts by Morton key.
  * ``offline``: 2 ranks x 2 shards and 4 x 1, ``odometry_offline_sharded``
    over 8 frames of ``test_parallel.py``'s 8x128 scans, each rank's last
    pair against the next rank's first frame (the halo); terminations equal
    and poses within 1e-5 m of ``odometry_offline``. And
    ``extract_features_sharded``, each rank a row of a (2 data x 2 line)
    mesh, or of a (4 data x 1 line) one: equal to ``extract_features_batch``.
  * ``many``: ``pose_graph``, ``scan_to_map`` and ``offline`` one after
    another in one group, each held as above, for 8 ranks x 1 shard
    (``tests/test_torch_world_sizes.py``, on two hosts of four).
  * ``from_numpy``: 2 ranks x 1 shard load ``loam_tpu``'s sharded
    scan-to-map state of two shards, which the test writes with JAX after 4
    frames (``ScanToMapState.from_numpy(mesh=)``): each rank holds its own
    rows, and two more frames from it are bit-equal across the ranks and to
    one rank of two shards.

Every rank of every case also checks the port's rules past one rank: every
sharded call is a cached program of the mesh (scan-to-map, with its
registration inline, and the pose graph too, whose gathers run inside
conditional bodies on the card), a gather on a CPU mesh inside a
conditional body's capture runs the plain gather, and ranks that disagree
on their shards make no mesh.

Every rank's result must equal every other rank's and an in-process run on
one rank holding all the shards (1 x 4, 1 x 2) bit for bit: the collectives
add in global shard order (``parallel/collectives.py``), and each data
row's block is registered on its own (``sharding._per_row``).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from loam_tpu_torch import parallel, program
from loam_tpu_torch.io import random_pose_graph, render_trajectory
from loam_tpu_torch.params import FeatureExtractionParams, LidarParams, RegistrationParams
from loam_tpu_torch.parallel import collectives
from loam_tpu_torch.parallel import distributed as tdist
from loam_tpu_torch.parallel.distributed import scan_to_map_init_sharded, scan_to_map_step_sharded
from loam_tpu_torch.pose_graph import optimize_pose_graph, optimize_pose_graph_sharded
from loam_tpu_torch.features import extract_features, extract_features_batch
from loam_tpu_torch.geometry import Pose3
from loam_tpu_torch.map import VoxelMap
from loam_tpu_torch.odometry import (ScanToMapConfig, ScanToMapState, odometry_offline, scan_to_map_init,
                                     scan_to_map_step_features)
from loam_tpu_torch.registration import azimuth_sort_features

torch.set_num_threads(1)

_HERE = os.path.dirname(os.path.abspath(__file__))
# shards a rank holds, by mode and ranks
SHARDS = {("pose_graph", 2): 2, ("scan_to_map", 2): 1, ("offline", 2): 2, ("from_numpy", 2): 1,
          ("pose_graph", 4): 1, ("scan_to_map", 4): 1, ("offline", 4): 1, ("many", 8): 1}
GRAPH_TOL = 1e-8
POS_TOL = 1e-5
TIMEOUT_S = 300


def _pose_graph(mesh, line, out_dir):
    """The sharded solve and its single-device twin on the same graph."""
    _, init, edges = random_pose_graph(60, 6, seed=7)  # 65 edges
    pad = (-edges.i.shape[0]) % mesh.size
    edges = type(edges)(
        torch.cat([edges.i, torch.zeros(pad, dtype=torch.int32)]),
        torch.cat([edges.j, torch.ones(pad, dtype=torch.int32)]),
        type(edges.measurement)(*(torch.cat([x, x[:1].expand((pad,) + x.shape[1:])])
                                  for x in edges.measurement)),
        torch.cat([edges.weight, torch.zeros(pad, dtype=edges.weight.dtype)]),
        torch.cat([edges.mask, torch.zeros(pad, dtype=torch.bool)]),
    )
    got, cost = optimize_pose_graph_sharded(init, edges, mesh, iterations=5)
    want, want_cost = optimize_pose_graph(init, edges, iterations=5)
    return (dict(translation=got.translation.numpy(), rotation=got.rotation.numpy(),
                 cost=cost.numpy()),
            dict(translation=want.translation.numpy(), rotation=want.rotation.numpy(),
                 cost=want_cost.numpy()))


S2M_LIDAR = LidarParams(8, 256, 0.5, 80.0)
S2M_FEAT = FeatureExtractionParams(precise_selection=False)
S2M_REG = RegistrationParams(max_iterations=2, min_associations=10, prior_weight=300.0)


def _s2m_scans(frames):
    scans, _ = render_trajectory(S2M_LIDAR, frames, step=np.array([0.05, 0.0, 0.0]), noise=0.003, seed=5,
                                 dtype=np.float32)
    return scans


def _s2m_config(shards):
    return ScanToMapConfig(edge_capacity=512 * shards, planar_capacity=2048 * shards)


def _s2m_frames(mesh, sh, one, scans):
    """Sharded steps from ``sh`` and, when ``one`` is a state, the
    single-device steps on the same azimuth-sorted features; the sharded
    maps gathered whole."""
    cfg = _s2m_config(mesh.size)
    got, want = {"t": [], "q": [], "fsi": []}, {"t": [], "q": [], "fsi": []}
    for f in range(scans.shape[0]):
        x = torch.from_numpy(scans[f])
        sh, pose, _ = scan_to_map_step_sharded(sh, x, S2M_LIDAR, mesh, S2M_FEAT, S2M_REG, cfg)
        outs = [(got, pose, sh)]
        if one is not None:
            feats = azimuth_sort_features(extract_features(x, S2M_LIDAR, S2M_FEAT))
            one, pose1, _ = scan_to_map_step_features(one, feats, S2M_REG, cfg)
            outs.append((want, pose1, one))
        for out, p, s in outs:
            out["t"].append(p.translation.numpy())
            out["q"].append(p.rotation.numpy())
            out["fsi"].append(int(s.frames_since_insert))
    whole = lambda m: tuple(collectives.gather(mesh, x).numpy() for x in (m.points, m.mask))
    (ep, em), (pp, pm) = whole(sh.edge_map), whole(sh.planar_map)
    res = {k: np.asarray(v) for k, v in got.items()}
    res.update(edge_points=ep, edge_mask=em, planar_points=pp, planar_mask=pm,
               dropped=np.asarray(int(sh.dropped)))
    return res, {k: np.asarray(v) for k, v in want.items()}


def _scan_to_map(mesh, line, out_dir):
    """Six sharded steps and the single-device ones on the same frames."""
    cfg = _s2m_config(mesh.size)
    return _s2m_frames(mesh, scan_to_map_init_sharded(cfg, mesh), scan_to_map_init(cfg, device="cpu"),
                       _s2m_scans(6))


def _from_numpy(mesh, line, out_dir):
    """``loam_tpu``'s sharded state of ``mesh.size`` shards, as the test
    wrote it (``<out_dir>/state.npz``), loaded onto this rank's shards; its
    own rows, and two more frames from it."""
    with np.load(os.path.join(out_dir, "state.npz")) as z:
        v = {k: z[k] for k in z.files}
    vmap = lambda n: VoxelMap(v[f"{n}_points"], v[f"{n}_mask"], v[f"{n}_voxel_size"], v[f"{n}_origin"])
    pose = lambda n: Pose3(v[f"{n}_rotation"], v[f"{n}_translation"])
    state = ScanToMapState(vmap("edge"), vmap("planar"), pose("current"), pose("delta"), pose("keyframe"),
                           v["frames_since_insert"])
    st = ScanToMapState.from_numpy(state, mesh=mesh)
    rows = list(mesh.shard_ids)
    for n in ("edge", "planar"):
        m = getattr(st, f"{n}_map")
        assert m.points.shape[0] == len(rows)
        np.testing.assert_array_equal(m.points.numpy(), v[f"{n}_points"][rows])
        np.testing.assert_array_equal(m.mask.numpy(), v[f"{n}_mask"][rows])
    res, _ = _s2m_frames(mesh, st, None, _s2m_scans(6)[4:])
    res["rows"] = np.asarray(rows)
    return res, None


def _offline(mesh, line, out_dir):
    """Sharded offline odometry and extraction beside the single-device
    runs; the features compared here, the poses in :func:`_check_single`."""
    lidar = LidarParams(8, 128, 0.5, 80.0)
    feat = FeatureExtractionParams(number_sectors=2)
    reg = RegistrationParams(max_iterations=2, min_associations=10)
    scans, _ = render_trajectory(lidar, 8, step=np.array([0.05, 0.0, 0.0]), noise=0.003, seed=5,
                                 dtype=np.float32)
    traj, det = parallel.odometry_offline_sharded(scans, lidar, mesh, feat, reg)
    one, det1 = odometry_offline(scans, lidar, feat, reg, device="cpu")
    rows = parallel.make_mesh(list(mesh.devices), line_axis=line, group=mesh.group)
    feats = parallel.extract_features_sharded(scans, lidar, rows, feat)
    for a, b in zip(feats, extract_features_batch(torch.from_numpy(scans), lidar, feat)):
        assert torch.equal(a, b)
    res = dict(t=traj.translation.numpy(), q=traj.rotation.numpy(), term=det.termination.numpy(),
               **{f: x.numpy() for f, x in zip(feats._fields, feats)})
    return res, dict(t=one.translation.numpy(), q=one.rotation.numpy(), term=det1.termination.numpy())


def _many(mesh, line, out_dir):
    """``pose_graph``, ``scan_to_map`` and ``offline`` on one mesh, each
    held to its single-device run here and its programs checked (the
    mesh's earlier ones dropped first); their results under
    ``<mode>.<key>``."""
    got = {}
    for mode in MANY:
        program.forget(mesh=mesh.token)
        res, want = RUN[mode](mesh, line, out_dir)
        _check_single(mode, res, want)
        if mesh.group is not None:
            _check_programs(mode, mesh)
        got.update({f"{mode}.{k}": v for k, v in res.items()})
    return got, None


def _check_single(mode, got, want):
    """The sharded result against the single-device one."""
    if mode in ("from_numpy", "many"):
        return
    if mode == "pose_graph":
        for key in ("translation", "rotation"):
            np.testing.assert_allclose(got[key], want[key], atol=GRAPH_TOL, rtol=0, err_msg=key)
        np.testing.assert_allclose(got["cost"], want["cost"], rtol=1e-8, atol=1e-20)
    else:
        np.testing.assert_array_equal(got["fsi" if mode == "scan_to_map" else "term"],
                                      want["fsi" if mode == "scan_to_map" else "term"])
        np.testing.assert_allclose(got["t"], want["t"], atol=POS_TOL, rtol=0)
        np.testing.assert_allclose(got["q"], want["q"], atol=POS_TOL, rtol=0)
        if mode == "scan_to_map":
            assert int(got["dropped"]) == 0


# the programs a mode's run caches for its mesh, past one rank as at one:
# scan-to-map's registration runs inline in its frame's program
PROGRAMS = {"pose_graph": {"pose_graph_sharded"}, "scan_to_map": {"scan_to_map_sharded"},
            "from_numpy": {"scan_to_map_sharded"}, "offline": {"offline_sharded"}}


def _check_programs(mode, mesh):
    """Past one rank every sharded call is a cached program of the mesh,
    those whose gathers run inside a conditional body on the card
    (scan-to-map, its registration, the pose graph) as the others: no rule
    keeps them eager. A registration called on its own is one too."""
    paths = lambda: {p.info.get("path") for progs in program._cache.values() for p in progs.values()
                     if p.info.get("mesh") == mesh.token}
    assert paths() == PROGRAMS[mode], paths()
    if mode == "scan_to_map":
        feats = extract_features(torch.from_numpy(_s2m_scans(1)[0]), S2M_LIDAR, S2M_FEAT)
        local = lambda x: x.reshape((mesh.size, -1) + x.shape[1:])[list(mesh.shard_ids)].flatten(0, 1)
        tdist.register_features_sharded(feats, feats.map(local), Pose3.identity(torch.float32), mesh, S2M_REG)
        assert paths() == PROGRAMS[mode] | {"sharded"}, paths()


def _check_mesh_rules(mesh):
    """Past one rank: ranks that disagree on their shards a rank make no
    mesh (``make_mesh``'s gather), and a gather on a CPU mesh while a
    conditional body is being captured runs the plain gather (the kernel's
    gather is the card's, captured anywhere): every rank's block, in rank
    order."""
    rank, world = dist.get_rank(mesh.group), dist.get_world_size(mesh.group)
    with pytest.raises(ValueError, match="meshes differ"):
        parallel.make_mesh(["cpu"] * (1 + rank), group=mesh.group)
    was = program.capturing_body
    program.capturing_body = lambda: True
    try:
        got = collectives.gather(mesh, torch.full((2, 3), float(rank)))
    finally:
        program.capturing_body = was
    assert torch.equal(got, torch.arange(world, dtype=torch.float32).repeat_interleave(2)[:, None].expand(-1, 3))


RUN = {"pose_graph": _pose_graph, "scan_to_map": _scan_to_map, "offline": _offline, "from_numpy": _from_numpy,
       "many": _many}
MANY = ("pose_graph", "scan_to_map", "offline")


def _line(mode, world) -> int:
    """The extraction mesh's line axis: a rank's two shards a row, else 1."""
    return 2 if SHARDS[mode, world] % 2 == 0 else 1


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(mode, out_dir, world=2, hosts=""):
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env["PYTHONPATH"] = os.path.dirname(_HERE) + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(world), str(port), mode, str(out_dir), hosts],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        cwd=os.path.dirname(_HERE)) for r in range(world)]
    outputs = []
    try:
        for p in procs:
            outputs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out}"
        assert f"[rank {r}] OK" in out, out
    return [dict(np.load(os.path.join(out_dir, f"rank{r}.npz"))) for r in range(world)]


def _bit_equal_to_one_rank(mode, tmp_path, world=2, hosts=""):
    ranks = _run_ranks(mode, tmp_path, world, hosts)
    mine, want = RUN[mode](parallel.make_mesh(["cpu"] * (world * SHARDS[mode, world])), _line(mode, world),
                           str(tmp_path))
    _check_single(mode, mine, want)
    for r, res in enumerate(ranks):
        assert sorted(k for k in res if k != "islands") == sorted(mine)
        for key in mine:
            if key != "rows":  # the shards a rank loaded (from_numpy)
                np.testing.assert_array_equal(res[key], mine[key], err_msg=f"rank {r} {key}")
    return ranks


def test_two_ranks_pose_graph(tmp_path):
    _bit_equal_to_one_rank("pose_graph", tmp_path)


def test_two_ranks_scan_to_map(tmp_path):
    _bit_equal_to_one_rank("scan_to_map", tmp_path)


def test_two_ranks_offline_and_extraction(tmp_path):
    _bit_equal_to_one_rank("offline", tmp_path)


@pytest.mark.parametrize("mode", ["pose_graph", "scan_to_map", "offline"])
def test_four_ranks_of_one_shard(tmp_path, mode):
    """4 ranks x 1 shard, bit-equal to each other and to 1 rank x 4 shards."""
    _bit_equal_to_one_rank(mode, tmp_path, world=4)


def test_two_ranks_load_loam_tpu_sharded_state(tmp_path):
    """``loam_tpu``'s (D, C, ...) sharded state, written with JAX after 4
    frames on 2 virtual devices, loads onto 2 ranks of one shard each:
    rank r holds row r, and the next 2 frames agree bit for bit with one
    rank of two shards and within 1e-2 m / 1e-3 rad (F6) of ``loam_tpu``'s
    sharded step from the same state."""
    import jax
    import jax.numpy as jnp

    import loam_tpu as J
    import loam_tpu.parallel as jpar
    from loam_tpu.odometry import scan_to_map as j_s2m
    from loam_tpu.parallel import distributed as jdist

    lidar = J.LidarParams(8, 256, 0.5, 80.0)
    feat = J.FeatureExtractionParams(precise_selection=False)
    reg = J.RegistrationParams(max_iterations=2, min_associations=10, prior_weight=300.0)
    cfg = j_s2m.ScanToMapConfig(edge_capacity=512 * 2, planar_capacity=2048 * 2)
    jmesh = jpar.make_mesh(jax.devices()[:2])
    scans = _s2m_scans(6)
    st = jdist.scan_to_map_init_sharded(cfg, jmesh)
    step = lambda s, x: jdist.scan_to_map_step_sharded(s, jnp.asarray(x), lidar, jmesh, feat_params=feat,
                                                       reg_params=reg, config=cfg)
    for f in range(4):
        st, _, _ = step(st, scans[f])
    leaves = {"frames_since_insert": np.asarray(st.frames_since_insert)}
    for n, m in (("edge", st.edge_map), ("planar", st.planar_map)):
        leaves.update({f"{n}_{k}": np.asarray(getattr(m, k)) for k in ("points", "mask", "voxel_size", "origin")})
    for n, p in (("current", st.world_T_current), ("delta", st.prev_delta), ("keyframe", st.world_T_keyframe)):
        leaves.update({f"{n}_rotation": np.asarray(p.rotation), f"{n}_translation": np.asarray(p.translation)})
    assert leaves["edge_points"].shape[0] == 2 and leaves["edge_mask"].any()
    np.savez(tmp_path / "state.npz", **leaves)
    ranks = _bit_equal_to_one_rank("from_numpy", tmp_path)
    assert [res["rows"].tolist() for res in ranks] == [[0], [1]]
    for f in range(4, 6):
        st, jpose, _ = step(st, scans[f])
        got = ranks[0]
        assert got["fsi"][f - 4] == int(st.frames_since_insert)
        np.testing.assert_allclose(got["t"][f - 4], np.asarray(jpose.translation), atol=1e-2, rtol=0)
        np.testing.assert_allclose(got["q"][f - 4], np.asarray(jpose.rotation), atol=1e-3, rtol=0)


def main(rank: int, world: int, port: int, mode: str, out_dir: str, hosts: str = "") -> None:
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank)
    try:
        mesh = parallel.make_mesh(["cpu"] * SHARDS[mode, world], group=dist.group.WORLD,
                                  hosts=hosts.split(",") if hosts else None)
        got, want = RUN[mode](mesh, _line(mode, world), out_dir)
        if hosts:  # each rank's island, as this rank's mesh sees them
            got["islands"] = np.asarray([next(i for i, isl in enumerate(mesh.islands) if r in isl)
                                         for r in range(world)])
        _check_single(mode, got, want)
        if mode != "many":  # its modes' programs are checked as they run
            _check_programs(mode, mesh)
        _check_mesh_rules(mesh)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **got)
    finally:
        dist.destroy_process_group()
    print(f"[rank {rank}] OK", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5], *sys.argv[6:])
