"""One rank of the mesh cell on the CPU (gloo), at a small size: the
multi-card path of ``run.py`` (its stop rule, the sharded entry, the check
on every rank) without a card. ``test_loambench_mesh.py`` starts four.

    python loambench/tests/mesh_rank.py <rank> <world> <port> <out.json> [no_exchange]

``no_exchange``: the fault of a mesh whose ranks do not exchange their
search results (each rank's gather returns its own block in every rank's
place).
"""

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402


def _no_exchange(world: int):
    def gather(mesh, tree):
        return type(tree)(x.repeat((world,) + (1,) * (x.ndim - 1)) for x in tree)
    return gather


def main(rank: int, world: int, port: int, out: str, fault: str = None) -> int:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank)
    try:
        from loam_tpu_torch import parallel
        from loam_tpu_torch.parallel import distributed

        if fault == "no_exchange":
            distributed.collectives.gather = _no_exchange(world)

        from loambench import cells
        from loambench.run import Ranks, run_cell

        # the cell from its files (BENCHMARK.json may not list it yet)
        read = lambda *part: json.loads(cells.HERE.joinpath(*part).read_text())
        cell = {"config": dict(read("configs", "os1-64-s2m-mesh4.json"), name="os1-64-s2m-mesh4"),
                "traffic": read("traffic", "walk16.json"),
                "limits": read("limits", "s2m-os1-64-mesh4-walk16.json"), "per_layer": [], "end_to_end": []}
        cell["config"]["lidar"].update(scan_lines=16, points_per_line=360, max_range=80.0)
        cell["config"]["scan_to_map"].update(edge_capacity=2048, planar_capacity=8192)
        cell["traffic"].update(frames=6, segments=1, check=1)
        mesh = parallel.make_mesh(["cpu"], group=dist.group.WORLD)
        comm = Ranks(dist.group.WORLD, world)
        result, rows = run_cell(cell, 2**31 + 99, 0.5, False, torch.device("cpu"), mesh, comm, log=lambda s: None)
    finally:
        dist.destroy_process_group()
    with open(out, "w") as f:
        json.dump({"result": result, "rows": rows}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], *sys.argv[5:]))
