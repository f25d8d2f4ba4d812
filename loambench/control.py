#!/usr/bin/env python3
"""The two readings each limit of ``limits/<cell>.json`` is set between.

    python3 loambench/control.py --workload <cell> --seeds <n> ... [--control 3] [--no-program]

For every seed: the cell's segments rendered as a run renders them, the
program's entry called once on each judged segment (warmed first, as a
run's window calls it) and compared with the float64 reference (the lower
reading: the largest over the seeds); then, on the first ``--control``
seeds, the control -- the reference computed in bfloat16 (scans and maps
rounded to it, the searches in it, the fits and the solve in float32), put
in the program's place -- compared with the same reference (the upper
reading: the smallest over those seeds). Prints one JSON line a seed and a
summary. A multi-rank cell's program readings come from its runs;
``--no-program`` reads the control alone. Not part of a benchmark run.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def readings(workload: str, seeds: list, control: int, program: bool, device=None, cell=None, log=print) -> dict:
    import torch

    from loambench import cells, judge, scene

    cell = cell or cells.cell(workload)
    config, mix = cell["config"], cell["traffic"]
    device = device or torch.device("cuda", 0)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    path = cells.entry(config)
    entry = path.Entry(config, device, None) if program else None
    low, high = [], []
    for i, seed in enumerate(seeds):
        segs = scene.segments(mix, config["lidar"], seed, device)
        judged = scene.judged(mix, seed)
        row = {"seed": seed}
        t = time.perf_counter()
        refs = {k: path.reference(config, segs[k].scans, torch.float64) for k in judged}
        row["reference_s"] = time.perf_counter() - t
        if program:
            got = []
            for k in judged:
                entry.call(segs[k].scans)
                got.append(path.compare(config, entry.settle(entry.keep(entry.call(segs[k].scans), True)), refs[k]))
            row["program"] = judge.worst(got)
            low.append(row["program"])
        if i < control:
            got = []
            for k in judged:
                ctl = path.reference(config, segs[k].scans, torch.bfloat16)
                got.append(compare_control(path, config, ctl, refs[k]))
            row["control"] = judge.worst(got)
            high.append(row["control"])
        log(json.dumps(row))
    lower = judge.worst(low) if low else {}
    upper = {k: min(r[k] for r in high if k in r) for k in (high[0] if high else {})}
    out = {"workload": workload, "seeds": seeds, "lower": lower, "upper": upper}
    log(json.dumps(out))
    return out


def compare_control(path, config, ctl: dict, ref: dict) -> dict:
    """The control's outputs judged as a program's would be (its maps
    whole, unsharded)."""
    import torch

    kept = {"q": ctl["trajectory"][0].to(torch.float64), "t": ctl["trajectory"][1].to(torch.float64),
            "fits": ctl["first_fits"], "maps": None}
    if "edge_map" in ctl:
        kept["maps"] = (tuple(ctl["edge_map"]), tuple(ctl["planar_map"]))
    return path.compare(config, kept, ref)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--no-program", action="store_true")
    a = p.parse_args(argv)
    readings(a.workload, a.seeds, a.control, not a.no_program)
    return 0


if __name__ == "__main__":
    sys.exit(main())
