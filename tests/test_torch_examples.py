"""The port's examples (``examples/torch_*.py``) run end to end on the CPU.

Each example runs with ``--device cpu`` in its own process at a small size;
all of them start at once (a module fixture), two threads each, so the file
takes about as long as its slowest example. An example's own ``assert``s
pass when it exits with 0. Scan-to-scan ``--offline`` and streaming print the
same ATE as their ``loam_tpu`` twins at the same arguments, within 1e-3 m:
the same trajectory registered by the same algorithm in float32, whose
summation orders differ. The scan-to-map example's checkpoint resumes in
``loam_tpu``'s example, and ``loam_tpu``'s in the port's.
"""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples"

#: name -> the port's example and its arguments (``--device cpu`` added)
PORT_RUNS = {
    "scan_to_scan": ["torch_scan_to_scan_odometry.py", "--frames", "6"],
    "scan_to_scan_offline": ["torch_scan_to_scan_odometry.py", "--frames", "6", "--offline"],
    "scan_to_map": ["torch_scan_to_map_odometry.py", "--frames", "4", "--checkpoint", "{tmp}/state.npz"],
    "streaming": ["torch_streaming_odometry.py", "6"],
    # six keyframes on a loop of 0.5 m: 60 degrees a frame, still registered
    "full_slam": ["torch_full_slam.py", "--frames", "6", "--radius", "0.5"],
    "distributed_mapping": ["torch_distributed_mapping.py"],
    # two ranks of one shard each over gloo
    "distributed_mapping_ranks": ["torch_distributed_mapping.py", "--ranks", "2"],
    "sharded_offline": ["torch_sharded_offline.py", "--shards", "2", "--frames", "4", "--beams", "16",
                        "--points", "256", "--reps", "1"],
}
#: name -> the loam_tpu twin at the same arguments, for the ATE
JAX_RUNS = {
    "scan_to_scan_offline": ["scan_to_scan_odometry.py", "--frames", "6", "--offline", "--cpu"],
    "streaming": ["streaming_odometry.py", "6"],
    "scan_to_map": ["scan_to_map_odometry.py", "--frames", "2", "--cpu", "--checkpoint", "{tmp}/jax_state.npz"],
}
#: a line each run must print
PRINTS = {
    "scan_to_scan": "ATE vs ground truth:",
    "scan_to_scan_offline": "ATE vs ground truth:",
    "scan_to_map": "state saved to",
    "streaming": "end position error:",
    "full_slam": "mean error:",
    "distributed_mapping": "max |sharded - single-device| translation:",
    "distributed_mapping_ranks": "max |sharded - single-device| translation:",
    "sharded_offline": "offline_sharded:",
}
#: the ATE line of each example with a twin: regex -> metres per unit
ATE = {
    "scan_to_scan_offline": (r"ATE vs ground truth: ([0-9.]+) cm", 1e-2),
    "streaming": (r"ATE: ([0-9.]+) m", 1.0),
}


def _start(script, args, tmp, port):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    cmd = [sys.executable, str(EXAMPLES / script), *(a.format(tmp=tmp) for a in args)]
    if port:
        cmd += ["--device", "cpu"]
    return subprocess.Popen(cmd, cwd=tmp, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """name -> (exit code, output) of every run: the port's (``name``), the
    twins' (``jax:name``) and the scan-to-map checkpoints resumed
    (``resume``, ``jax:resume``, ``resume_jax_file``)."""
    tmp = tmp_path_factory.mktemp("examples")
    procs = {name: _start(s, a, tmp, True) for name, (s, *a) in PORT_RUNS.items()}
    procs.update({f"jax:{name}": _start(s, a, tmp, False) for name, (s, *a) in JAX_RUNS.items()})
    # each checkpoint resumed in the other package as soon as it is written
    resumes = {"resume": ("scan_to_map", "torch_scan_to_map_odometry.py", "state.npz", True),
               "jax:resume": ("scan_to_map", "scan_to_map_odometry.py", "state.npz", False),
               "resume_jax_file": ("jax:scan_to_map", "torch_scan_to_map_odometry.py", "jax_state.npz", True)}
    out = {}
    for name, (after, script, file, port) in resumes.items():
        if after not in out:
            out[after] = (procs[after].communicate(timeout=600)[0], procs[after].returncode)
        args = ["--frames", "2", "--resume", f"{{tmp}}/{file}"] + ([] if port else ["--cpu"])
        procs[name] = _start(script, args, tmp, port)
    try:
        for name, p in procs.items():
            if name not in out:
                out[name] = (p.communicate(timeout=600)[0], p.returncode)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    return {k: (rc, text) for k, (text, rc) in out.items()}


@pytest.mark.parametrize("name", sorted(PORT_RUNS))
def test_example_runs_on_the_cpu(runs, name):
    rc, text = runs[name]
    assert rc == 0, text[-3000:]
    assert PRINTS[name] in text, text[-3000:]
    if name == "distributed_mapping":
        assert "devices: 8 x cpu" in text and text.rstrip().endswith("OK")
    if name == "distributed_mapping_ranks":
        assert "devices: 2 x cpu, 2 ranks" in text and "OK" in text.splitlines()


@pytest.mark.parametrize("name", sorted(ATE))
def test_example_ate_matches_loam_tpu(runs, name):
    pattern, unit = ATE[name]
    (rc_t, port), (rc_j, ref) = runs[name], runs[f"jax:{name}"]
    assert rc_t == 0 and rc_j == 0, (port[-2000:], ref[-2000:])
    a, b = (float(re.search(pattern, t).group(1)) * unit for t in (port, ref))
    assert abs(a - b) <= 1e-3, (a, b)


@pytest.mark.parametrize("saved,resumed", [("scan_to_map", "resume"), ("scan_to_map", "jax:resume"),
                                           ("jax:scan_to_map", "resume_jax_file")],
                         ids=["port_to_port", "port_to_loam_tpu", "loam_tpu_to_port"])
def test_scan_to_map_example_checkpoint_resumes(runs, saved, resumed):
    """The scan-to-map checkpoint resumes in the package that wrote it and in
    the other: ``loam_tpu``'s npz schema."""
    (rc, text), (rc_r, text_r) = runs[saved], runs[resumed]
    assert rc == 0 and rc_r == 0, (text[-2000:], text_r[-2000:])
    edge, planar = re.search(r"map: (\d+) edge voxels, (\d+) planar voxels", text).groups()
    assert f"(map sizes {edge}/{planar})" in text_r, text_r[-3000:]


@pytest.mark.parametrize("script", sorted(p.name for p in EXAMPLES.glob("torch_*.py")))
def test_example_imports_neither_jax_nor_loam_tpu(script):
    tree = ast.parse((EXAMPLES / script).read_text())
    names = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module}
    assert not names & {"jax", "jaxlib", "loam_tpu", "loam"}, names


def test_example_without_a_card_raises():
    """No ``--device`` means the GPU (``loam_tpu_torch/device.py``): without
    one the example fails instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present: the example would run on it")
    done = subprocess.run([sys.executable, str(EXAMPLES / "torch_scan_to_scan_odometry.py"), "--frames", "2"],
                          capture_output=True, text=True, timeout=300)
    assert done.returncode != 0
    assert "CUDA" in done.stderr, done.stderr[-2000:]
