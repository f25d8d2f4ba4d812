"""What ``BENCHMARK.json`` names, found by name: a cell's configuration,
traffic mix and limits, the entry module a configuration names, and the
reader of each per-layer metric. Adding a configuration, a mix, a cell or
a metric adds files; no file here lists them."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

#: The benchmark's folder and the checkout it lies in.
HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(name: str, root: Path = ROOT) -> dict:
    """Everything one cell needs: ``workload`` (its entry), ``config`` (the
    configuration file's contents, with its ``name``), ``traffic`` (the mix's
    parameters), ``limits`` (the correctness check's, ``limits/<cell>.json``),
    ``end_to_end`` and ``per_layer`` (the metrics reported in the cell)."""
    bench = benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}.get(name)
    if work is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = {c["name"]: c for c in bench["configs"]}[work["config"]]
    config = dict(_json(root / conf["file"]), name=conf["name"])
    here = root / HERE.name
    traffic = _json(here / "traffic" / f"{work['traffic']}.json")
    limits = _json(here / "limits" / f"{name}.json")
    reports = lambda m: "workloads" not in m or name in m["workloads"]
    return {"workload": work, "config": config, "traffic": traffic, "limits": limits,
            "end_to_end": [m for m in bench["end_to_end"] if reports(m)],
            "per_layer": [m for m in bench["per_layer"] if reports(m)]}


def load(path: Path, name: str):
    """The module in ``path`` (a file named after a configuration's entry
    or a metric, so it need not be a Python identifier)."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def entry(config: dict, root: Path = ROOT):
    """The entry module the configuration names (``entries/<entry>.py``)."""
    return load(root / HERE.name / "entries" / f"{config['entry']}.py", f"loambench_entry_{config['entry']}")


def reader(metric: str, root: Path = ROOT):
    """The reader of a per-layer metric (``metrics/<name>.py``)."""
    return load(root / HERE.name / "metrics" / f"{metric}.py", f"loambench_metric_{metric}")
