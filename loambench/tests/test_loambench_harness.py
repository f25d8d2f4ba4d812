"""CPU tests of the benchmark's harness: every cell resolves to its files,
what a later change adds is found by name, the yardstick's arithmetic on
fixed inputs, the device renderer against ``io.synthetic``, and the
refusals (no card, no program, modules that may not be loaded).

    python -m pytest loambench/tests -q -p no:xdist
"""

from __future__ import annotations

import ast
import json
import math
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from loambench import cells, measure, scene

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "loambench"


def test_every_cell_resolves_to_its_files():
    bench = cells.benchmark()
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file(), c["file"]
    for w in bench["workloads"]:
        cell = cells.cell(w["name"])
        assert callable(cells.entry(cell["config"]).Entry)
        assert cell["limits"], w["name"]
        assert {m["name"] for m in cell["end_to_end"]} >= {"setup_s"}
        assert len(cell["end_to_end"]) >= 2 and cell["per_layer"]
        for m in cell["per_layer"]:
            assert callable(cells.reader(m["name"]).read), m["name"]
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))


def test_a_new_config_mix_and_metric_are_found_by_name(tmp_path):
    """A later change adds files and entries only: a configuration, a mix,
    a cell's limits and a per-layer metric's reader in a copy are found
    without any file of the harness naming them."""
    shutil.copytree(BENCH, tmp_path / "loambench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    conf = dict(json.loads((BENCH / "configs" / "os1-64-s2s.json").read_text()), chunk_pairs=8)
    (tmp_path / "loambench/configs/throwaway-s2s.json").write_text(json.dumps(conf))
    mix = dict(json.loads((BENCH / "traffic" / "walk16.json").read_text()), frames=32)
    (tmp_path / "loambench/traffic/walk32.json").write_text(json.dumps(mix))
    (tmp_path / "loambench/limits/throwaway.walk32.json").write_text('{"pose_gap_m": 1.0}')
    (tmp_path / "loambench/metrics/icf.throwaway.py").write_text("def read(ctx):\n    return 42.0\n")
    bench["configs"].append({"name": "throwaway-s2s", "source": "https://example.org", "reduced": [],
                             "file": "loambench/configs/throwaway-s2s.json", "why": "a test"})
    bench["workloads"].append({"name": "throwaway.walk32", "config": "throwaway-s2s", "traffic": "walk32",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "icf.throwaway", "unit": "count", "better": "lower", "source": "program_counter",
                               "layer": "icf", "moves": "scans_per_s", "workloads": ["throwaway.walk32"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = cells.cell("throwaway.walk32", root=tmp_path)
    assert cell["config"]["chunk_pairs"] == 8 and cell["traffic"]["frames"] == 32
    assert cell["limits"] == {"pose_gap_m": 1.0}
    assert "icf.throwaway" in [m["name"] for m in cell["per_layer"]]
    assert cells.reader("icf.throwaway", root=tmp_path).read(None) == 42.0
    assert cells.entry(cell["config"], root=tmp_path).Entry is not None
    assert "icf.throwaway" not in [m["name"] for m in cells.cell("throwaway.walk32", root=tmp_path)["end_to_end"]]
    assert "icf.throwaway" not in [m["name"] for m in cells.cell(bench["workloads"][0]["name"], root=tmp_path)["per_layer"]]


def test_percentile_rate_union_and_gaps():
    assert measure.percentile(list(range(1, 101)), 95) == 95
    assert measure.percentile([3.0, 1.0, 2.0], 95) == 3.0
    assert measure.percentile([5.0], 95) == 5.0
    assert measure.rate(16 * 25, 2.0) == 200.0
    assert measure.union([(0, 1), (0.5, 2), (3, 4), (3.5, 3.6)]) == 3.0
    assert measure.union([]) == 0.0
    g = measure.gaps([(1, 2), (1.5, 3), (5, 6)], 0, 10)
    assert g == [(6, 10), (3, 5), (0, 1)]


def test_byte_bounds_from_shapes():
    # one 64 x 1024 frame: 6 sectors of up to 174 slots, caps 11 and 51
    rows, P, S, slots, e, p = 64, 1024, 6, 174, 11, 51
    cands, picks = S * slots, S * (e + p)
    want = rows * ((P * 8 + cands * 12) + (P + 2 * cands * 4 + picks * 4) + picks * 28)
    assert measure.extract_bytes(rows, P, S, slots, e, p) == want
    assert measure.share(1.0, 4.0) == 25.0 and measure.share(1.0, 0.0) is None


def test_device_renderer_matches_io_synthetic():
    from loam_tpu_torch.io.synthetic import Box, render_scan
    from loam_tpu_torch.params import LidarParams

    mix = json.loads((BENCH / "traffic" / "walk16.json").read_text())
    boxes, pos, yaw = scene.layout(mix, 3)
    lidar = LidarParams(8, 90, 0.5, 80.0)
    world = [Box(b[0], b[1]) for b in boxes]
    got = scene.render(8, 90, 80.0, pos[:3], yaw[:3], boxes, mix["room"])
    for f in range(3):
        want = render_scan(lidar, pos[f], yaw[f], world=world, room=mix["room"])
        np.testing.assert_allclose(got[f].numpy(), want, rtol=0, atol=1e-9)


def test_segments_keep_clear_and_seeds_change_only_the_noise():
    mix = dict(json.loads((BENCH / "traffic" / "drive16.json").read_text()), segments=3)
    lidar = {"scan_lines": 4, "points_per_line": 60, "max_range": 80.0}
    for k in range(3):
        boxes, pos, _ = scene.layout(mix, k)
        assert scene._clear(pos, boxes, mix["room"], mix["wall_margin"], mix["clearance"])
    a = scene.segments(mix, lidar, 7, "cpu")
    b = scene.segments(mix, lidar, 7, "cpu")
    c = scene.segments(mix, lidar, 2**31 + 12345, "cpu")
    assert all(torch.equal(x.scans, y.scans) for x, y in zip(a, b))
    assert not torch.equal(a[0].scans, c[0].scans)
    assert np.array_equal(a[1].positions, c[1].positions)
    assert a[0].positions[0].tolist() == [0.0, 0.0, 0.0]
    step = np.linalg.norm(np.diff(a[0].positions, axis=0), axis=-1)
    assert np.allclose(step, math.hypot(*mix["step"][:2]))
    assert sorted(scene.order(5, 9)) == list(range(5))
    assert len(scene.judged(dict(mix, segments=16), 2**31 + 5)) == mix["check"]


def _run(args, cwd, env=None):
    return subprocess.run([sys.executable, "loambench/run.py"] + args, cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def test_run_refuses_without_a_card():
    """No card, no run: code 2, nothing on standard output (no fallback to
    the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    name = cells.benchmark()["workloads"][0]["name"]
    p = _run(["--workload", name, "--seed", "1", "--seconds", "1", "--trace", "0"], ROOT)
    assert p.returncode == 2 and p.stdout == "", (p.returncode, p.stdout, p.stderr)


def test_run_fails_without_the_program(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's files."""
    shutil.copytree(BENCH, tmp_path / "loambench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    name = cells.benchmark()["workloads"][0]["name"]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = _run(["--workload", name, "--seed", "1", "--seconds", "1", "--trace", "0"], tmp_path, env)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_forbidden_modules_refuse_the_result(monkeypatch, capsys):
    from loambench import run

    monkeypatch.setitem(sys.modules, "jax", sys)  # stands for JAX loaded by the port
    assert run._finish({"correct": True}, []) != 0
    out = capsys.readouterr()
    assert out.out == "" and "jax" in out.err


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


def test_imports():
    """Nothing under loambench/ imports JAX or the JAX package (top-level
    names compared whole: the port's name begins with the JAX package's) or
    reads the JAX package's benchmarks; the reference imports nothing of the
    program."""
    files = [p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts]
    assert files
    for path in files:
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "loam_tpu", "bench", "benchmarks"}, (path, tops)
        text = path.read_text()
        if path.name != Path(__file__).name:
            assert "benchmarks/" not in text and "bench.py" not in text.replace("bench.py::", ""), path
        if "reference" in path.parts:
            assert "loam_tpu_torch" not in tops, path
