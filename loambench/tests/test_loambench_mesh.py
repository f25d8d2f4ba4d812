"""The mesh cell's path on the CPU: four gloo ranks, each a process, run
the sharded scan-to-map entry through ``run.run_cell`` at a small size; every
rank makes the same calls and comes out correct against the reference."""

from __future__ import annotations

import json
import socket
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def _ranks(tmp_path, *fault):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    outs = [tmp_path / f"rank{r}.json" for r in range(4)]
    procs = [subprocess.Popen([sys.executable, str(HERE / "mesh_rank.py"), str(r), "4", str(port), str(outs[r]),
                               *fault]) for r in range(4)]
    codes = [p.wait(timeout=600) for p in procs]
    assert codes == [0, 0, 0, 0]
    got = [json.loads(o.read_text()) for o in outs]
    assert len({g["result"]["attempted"] for g in got}) == 1
    for g in got:
        assert {r[0] for r in g["rows"]} >= {"pose_gap_m", "map_voxel_gap"}
    return got


def test_four_gloo_ranks(tmp_path):
    for g in _ranks(tmp_path):
        assert g["result"]["correct"], g["rows"]


def test_the_exchange_left_out(tmp_path):
    """Each rank searches its own shard of the maps alone."""
    assert not all(g["result"]["correct"] for g in _ranks(tmp_path, "no_exchange"))
