"""The readings the check's limits are set from (on the card; the benchmark's
own runs do not run this).

    python3 slambench/calibrate.py --workload CELL --seeds 1,2,3 [--control] [--half-batch]
        [--set KEY=JSON ...] [--map N]

For each seed in one process: the cell's set-up and warm-up as a run has
them (no window), then the compared numbers of the program against the
dense reference (the lower reading), and with ``--control`` of the
reference in the program's place with TF32 on (the control: the nearest
precision below the float32 with TF32 off that the port states), with
``--half-batch`` of the reference in the program's place with its losses
over half of the image rows (a planted fault).  ``--set`` and ``--map``
run the cell with config keys or a map size of its own (a witness, such as
the program at the shipped budgets and with tracking on; PERF.md).  One
JSON line a seed.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from slambench import cells, harness  # noqa: E402
from slambench.reference import check  # noqa: E402


def step_gaps(prog, ref):
    """The loss gap of each of the first three steps of each phase."""
    return {phase: [abs(float(a) - float(b)) / abs(float(b)) for a, b in
                    zip(prog[phase]["losses"][:3], ref[phase]["losses"][:3])]
            for phase in ("track", "map") if phase in ref}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--half-batch", action="store_true")
    ap.add_argument("--set", action="append", default=[],
                    help="KEY=JSON: a config key set on top of the cell's (a witness run)")
    ap.add_argument("--map", type=int, default=None, help="map_gaussians instead of the traffic's")
    args = ap.parse_args()
    spec = cells.cell_spec(args.workload)
    for kv in args.set:
        key, value = kv.split("=", 1)
        spec["traffic"]["set"][key] = json.loads(value)   # the traffic's keys win
    if args.map is not None:
        spec["traffic"]["map_gaussians"] = args.map
    dev = torch.device("cuda", 0)
    print(f"[calibrate] {torch.cuda.get_device_name(dev)}, nvidia-smi: {harness.power_limit()}",
          flush=True)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        res = harness.run_cell(spec, seed, None, False, t0, dev, log=lambda s: None)
        prog, ref = res["observations"]
        row = dict(cell=args.workload, seed=seed, set=args.set, map=args.map,
                   setup_s=res["setup_s"], check_s=res["check_s"],
                   program=check.numbers(prog, ref), steps=step_gaps(prog, ref),
                   n_added=prog["densify"]["n_added"] if prog["densify"] else None,
                   map_dropped=prog["map"]["dropped"] if prog["map"] else None,
                   losses={ph: dict(program=[float(x) for x in prog[ph]["losses"][:6]],
                                    reference=[float(x) for x in ref[ph]["losses"][:6]],
                                    argmin=[int(np.argmin(prog[ph]["losses"])),
                                            int(np.argmin(ref[ph]["losses"]))])
                           for ph in ("track", "map") if ph in ref})
        if args.control:
            ctl = check.reference_observations(res["inputs"], prog, dev, tf32=True)
            row["control"] = check.numbers(check.in_program_place(prog, ctl), ref)
            row["control_steps"] = step_gaps(ctl, ref)
        if args.half_batch:
            hb = check.reference_observations(res["inputs"], prog, dev, half=True)
            row["half_batch"] = check.numbers(check.in_program_place(prog, hb), ref)
            row["half_batch_steps"] = step_gaps(hb, ref)
        row["wall_s"] = time.time() - t0
        print(json.dumps(row), flush=True)
        del res, prog, ref
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
