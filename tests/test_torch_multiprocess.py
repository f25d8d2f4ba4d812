"""The port's mesh across processes: two ranks of a gloo group on the CPU,
the twin of ``test_multiprocess.py``.

Each test starts two processes running this file as a script,

    python tests/test_torch_multiprocess.py <rank> <world> <port> <mode> <out_dir>

which join a ``torch.distributed`` gloo group over 127.0.0.1, build a mesh of
their shards (``make_mesh(["cpu"] * shards, group=...)``), run the mode's
sharded path, check it against the rank's own single-device run, and write
the result to ``<out_dir>/rank<r>.npz``. The script imports no JAX and runs
on the CPU.

  * ``pose_graph``: 2 ranks x 2 shards, ``optimize_pose_graph_sharded`` on a
    60-node graph padded with masked edges to a multiple of 4; within 1e-8
    of ``optimize_pose_graph``.
  * ``scan_to_map``: 2 ranks x 1 shard, ``scan_to_map_step_sharded`` over 6
    frames of ``test_multiprocess.py``'s 8x256 scans; the keyframe decision
    equal every frame and poses within 1e-5 (m, and quaternion components)
    of the rank's single-device
    ``scan_to_map_step`` (the same neighbours and fits; equidistant map
    points may come in another order).

  * ``offline``: 2 ranks x 2 shards, ``odometry_offline_sharded`` over 8
    frames of ``test_parallel.py``'s 8x128 scans, each rank's last pair
    against the next rank's first frame (the halo); terminations equal and
    poses within 1e-5 m of ``odometry_offline``. And
    ``extract_features_sharded`` on a (2 data x 2 line) mesh, each rank a
    row: equal to ``extract_features_batch``.

Every rank's result must equal every other rank's and an in-process run on
one rank holding all the shards (1 x 4, 1 x 2) bit for bit: the collectives
add in global shard order (``parallel/collectives.py``).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import torch

from loam_tpu_torch import parallel
from loam_tpu_torch.io import random_pose_graph, render_trajectory
from loam_tpu_torch.params import FeatureExtractionParams, LidarParams, RegistrationParams
from loam_tpu_torch.parallel import collectives
from loam_tpu_torch.parallel.distributed import scan_to_map_init_sharded, scan_to_map_step_sharded
from loam_tpu_torch.pose_graph import optimize_pose_graph, optimize_pose_graph_sharded
from loam_tpu_torch.features import extract_features_batch
from loam_tpu_torch.odometry import ScanToMapConfig, odometry_offline, scan_to_map_init, scan_to_map_step

torch.set_num_threads(1)

_HERE = os.path.dirname(os.path.abspath(__file__))
SHARDS = {"pose_graph": 2, "scan_to_map": 1, "offline": 2}  # per rank, with 2 ranks
GRAPH_TOL = 1e-8
POS_TOL = 1e-5
TIMEOUT_S = 300


def _pose_graph(mesh):
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


def _scan_to_map(mesh):
    """Six sharded steps and the single-device ones on the same frames;
    the sharded maps gathered whole."""
    lidar = LidarParams(8, 256, 0.5, 80.0)
    feat = FeatureExtractionParams(precise_selection=False)
    reg = RegistrationParams(max_iterations=2, min_associations=10, prior_weight=300.0)
    cfg = ScanToMapConfig(edge_capacity=512 * mesh.size, planar_capacity=2048 * mesh.size)
    scans, _ = render_trajectory(lidar, 6, step=np.array([0.05, 0.0, 0.0]), noise=0.003, seed=5,
                                 dtype=np.float32)
    sh = scan_to_map_init_sharded(cfg, mesh)
    one = scan_to_map_init(cfg, device="cpu")
    got, want = {"t": [], "q": [], "fsi": []}, {"t": [], "q": [], "fsi": []}
    for f in range(scans.shape[0]):
        x = torch.from_numpy(scans[f])
        sh, pose, _ = scan_to_map_step_sharded(sh, x, lidar, mesh, feat, reg, cfg)
        one, pose1, _ = scan_to_map_step(one, x, lidar, feat, reg, cfg)
        for out, p, s in ((got, pose, sh), (want, pose1, one)):
            out["t"].append(p.translation.numpy())
            out["q"].append(p.rotation.numpy())
            out["fsi"].append(int(s.frames_since_insert))
    whole = lambda m: tuple(collectives.gather(mesh, x).numpy() for x in (m.points, m.mask))
    (ep, em), (pp, pm) = whole(sh.edge_map), whole(sh.planar_map)
    res = {k: np.asarray(v) for k, v in got.items()}
    res.update(edge_points=ep, edge_mask=em, planar_points=pp, planar_mask=pm,
               dropped=np.asarray(int(sh.dropped)))
    return res, {k: np.asarray(v) for k, v in want.items()}


def _offline(mesh):
    """Sharded offline odometry and extraction beside the single-device
    runs; the features compared here, the poses in :func:`_check_single`."""
    lidar = LidarParams(8, 128, 0.5, 80.0)
    feat = FeatureExtractionParams(number_sectors=2)
    reg = RegistrationParams(max_iterations=2, min_associations=10)
    scans, _ = render_trajectory(lidar, 8, step=np.array([0.05, 0.0, 0.0]), noise=0.003, seed=5,
                                 dtype=np.float32)
    traj, det = parallel.odometry_offline_sharded(scans, lidar, mesh, feat, reg)
    one, det1 = odometry_offline(scans, lidar, feat, reg, device="cpu")
    rows = parallel.make_mesh(list(mesh.devices), line_axis=2, group=mesh.group)
    feats = parallel.extract_features_sharded(scans, lidar, rows, feat)
    for a, b in zip(feats, extract_features_batch(torch.from_numpy(scans), lidar, feat)):
        assert torch.equal(a, b)
    res = dict(t=traj.translation.numpy(), q=traj.rotation.numpy(), term=det.termination.numpy(),
               **{f: x.numpy() for f, x in zip(feats._fields, feats)})
    return res, dict(t=one.translation.numpy(), q=one.rotation.numpy(), term=det1.termination.numpy())


def _check_single(mode, got, want):
    """The sharded result against the single-device one."""
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


RUN = {"pose_graph": _pose_graph, "scan_to_map": _scan_to_map, "offline": _offline}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(mode, out_dir, world=2):
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env["PYTHONPATH"] = os.path.dirname(_HERE) + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(world), str(port), mode, str(out_dir)],
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


def _bit_equal_to_one_rank(mode, tmp_path, world=2):
    ranks = _run_ranks(mode, tmp_path, world)
    mine, want = RUN[mode](parallel.make_mesh(["cpu"] * (world * SHARDS[mode])))
    _check_single(mode, mine, want)
    for r, res in enumerate(ranks):
        assert sorted(res) == sorted(mine)
        for key in mine:
            np.testing.assert_array_equal(res[key], mine[key], err_msg=f"rank {r} {key}")


def test_two_ranks_pose_graph(tmp_path):
    _bit_equal_to_one_rank("pose_graph", tmp_path)


def test_two_ranks_scan_to_map(tmp_path):
    _bit_equal_to_one_rank("scan_to_map", tmp_path)


def test_two_ranks_offline_and_extraction(tmp_path):
    _bit_equal_to_one_rank("offline", tmp_path)


def main(rank: int, world: int, port: int, mode: str, out_dir: str) -> None:
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank)
    try:
        mesh = parallel.make_mesh(["cpu"] * SHARDS[mode], group=dist.group.WORLD)
        got, want = RUN[mode](mesh)
        _check_single(mode, got, want)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **got)
    finally:
        dist.destroy_process_group()
    print(f"[rank {rank}] OK", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
