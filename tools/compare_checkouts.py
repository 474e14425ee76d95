#!/usr/bin/env python3
"""Compare checkouts of this repository on one card, alternating between them.

    python3 tools/compare_checkouts.py DIR [DIR ...] [--kernel-rounds N]
        [--reference-runs N] [--deterministic] [--tracking-table] [--slam-runs N]

Each DIR is a checkout (for example ``git archive`` of another commit,
unpacked).  Every run is a process of its own, started in DIR, so it uses
that checkout's ``hierslam_torch`` and kernels.  A kernel round runs
``chip_smoke.py --kernels`` in each DIR in order and then in reverse
(A B .. B A) and reads each kernel's time from its ``[kernels]`` line and,
where the checkout's ``chip_smoke.py`` prints them, the pixels whose last
committed or median slot or pair differs from the plain version's (K1, K3), and
K5's time on each of its inputs.  To hold an older checkout's
kernels to this one's checks and inputs, copy this ``chip_smoke.py`` over
its own; ``--tracking-table`` then has the first run record the flagship
run's tracking table into a temporary file and every run time K1/K2 on
that one table (``chip_smoke.py --tracking-table``).  A reference round runs
``chip_smoke.reference_phase`` with the ladder mapper (the 96x64 GPU run
against the CPU run) once in each DIR, in the same alternating order, and
reads its relative tracking-loss and mapping-loss differences and its
trajectory difference.  ``--deterministic`` runs the reference rounds with
``torch.use_deterministic_algorithms(True)``.  A SLAM round runs
``chip_smoke.slam_phase`` (the flagship's 8 frames at 1200x680) once in
each DIR, alternating, and reads its tracking_iter_ms and mapping_iter_ms.
The last line is a JSON object of every number read.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile

REFERENCE = """
import os, sys, torch
sys.path.insert(0, os.getcwd())
if sys.argv[1] == "1":
    torch.use_deterministic_algorithms(True, warn_only=True)
import chip_smoke
from hierslam_torch.ops import kernels
kernels.build()
chip_smoke.reference_phase(os.path.join("configs", "replica", "hierslam_semantic_run.py"),
                           "pallas")
"""
SLAM = """
import os, sys
sys.path.insert(0, os.getcwd())
import chip_smoke
from hierslam_torch.ops import kernels
kernels.build()
chip_smoke.slam_phase(os.path.join("configs", "replica", "hierslam_semantic_run.py"))
"""
MS_LINE = re.compile(r"\[kernels\] (.+?): K(\d) ([\d.]+) ms \(plain [^)]*\); K(\d) ([\d.]+) ms")
LAST_LINE = re.compile(r"\[kernels\] (.*) K[13]: .* differs from the plain version's (\d+)")
K5_LINE = re.compile(r"\[kernels\] (.+?) K5: .*?; K5 ([\d.]+) ms \(bound")
SLAM_LINE = re.compile(r"\[slam stream\] tracking_iter_ms ([\d.]+) mapping_iter_ms ([\d.]+)")
REF_LINE = re.compile(r"tracking loss rel (\S+), mapping loss rel (\S+), trajectory abs (\S+) m")


def run(cmd, cwd, env=None, check=True):
    p = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True, text=True)
    if p.returncode != 0:
        sys.stderr.write(p.stdout[-4000:] + p.stderr[-4000:])
        if check:
            raise RuntimeError(f"{' '.join(cmd[:3])} failed in {cwd} ({p.returncode})")
        print(f"[failed] {' '.join(cmd[:3])} in {cwd} ({p.returncode}): "
              f"{p.stderr.strip().splitlines()[-1:]}", flush=True)
    return p.stdout


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("dirs", nargs="+", help="checkouts to compare")
    ap.add_argument("--kernel-rounds", type=int, default=1)
    ap.add_argument("--reference-runs", type=int, default=0)
    ap.add_argument("--deterministic", action="store_true")
    ap.add_argument("--tracking-table", action="store_true",
                    help="time K1/K2 of every checkout on one recorded tracking table")
    ap.add_argument("--slam-runs", type=int, default=0,
                    help="flagship SLAM runs in each checkout, alternating")
    args = ap.parse_args()
    dirs = [os.path.abspath(d) for d in args.dirs]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    kern = {d: {} for d in dirs}
    last = {d: {} for d in dirs}
    ref = {d: [] for d in dirs}
    slam = {d: [] for d in dirs}
    out_dir = os.path.join(os.getcwd(), "chiprun_out")   # every run's output is kept there
    os.makedirs(out_dir, exist_ok=True)
    n_runs = 0
    shared = []
    if args.tracking_table:
        shared = ["--tracking-table",
                  os.path.join(tempfile.mkdtemp(), "tracking_table.pt")]
    for i in range(args.kernel_rounds):
        for d in dirs + dirs[::-1]:
            # a checkout whose kernels fail a check is still timed: the times
            # are read from the lines printed before the verdict
            out = run([sys.executable, "chip_smoke.py", "--kernels"] + shared, d, check=False)
            n_runs += 1
            with open(os.path.join(out_dir, f"compare_{n_runs:02d}_{os.path.basename(d)}.log"),
                      "w") as f:
                f.write(out)
            got = [(f"K{k}[{name}]", float(ms)) for name, k1, ms1, k2, ms2 in MS_LINE.findall(out)
                   for k, ms in ((k1, ms1), (k2, ms2))]
            got += [(f"K5[{name}]", float(ms)) for name, ms in K5_LINE.findall(out)]
            if not got:
                raise RuntimeError(f"no kernel times from {d}")
            for name, ms in got:
                kern[d].setdefault(name, []).append(ms)
            print(f"[kernels {i}] {d}: " + " ".join(f"{n} {ms}" for n, ms in got), flush=True)
            for name, n in LAST_LINE.findall(out):
                last[d].setdefault(name, []).append(int(n))
    for d in dirs:
        if last[d]:
            print(f"[last] {d}: pixels whose last commit or median differs from the plain "
                  f"version's: "
                  f"{json.dumps(last[d])}", flush=True)
    # cuBLAS is deterministic only with a fixed workspace, set before it starts
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8") if args.deterministic else None
    for i in range(args.reference_runs):
        for d in (dirs if i % 2 == 0 else dirs[::-1]):
            out = run([sys.executable, "-c", REFERENCE, str(int(args.deterministic))], d, env)
            vals = [float(v) for v in REF_LINE.search(out).groups()]
            ref[d].append(vals)
            print(f"[reference {i}] {d}: tracking {vals[0]!r} mapping {vals[1]!r} "
                  f"trajectory {vals[2]!r}", flush=True)
    for d in dirs:
        if ref[d]:
            above = sum(v[0] > 1e-4 for v in ref[d])
            print(f"[reference] {d}: {above} of {len(ref[d])} runs above 1e-4 in the "
                  f"tracking loss; distinct readings {len({tuple(v) for v in ref[d]})}",
                  flush=True)
    for i in range(args.slam_runs):
        for d in (dirs if i % 2 == 0 else dirs[::-1]):
            out = run([sys.executable, "-c", SLAM], d)
            n_runs += 1
            with open(os.path.join(out_dir, f"compare_{n_runs:02d}_{os.path.basename(d)}.log"),
                      "w") as f:
                f.write(out)
            vals = [float(v) for v in SLAM_LINE.search(out).groups()]
            slam[d].append(vals)
            print(f"[slam {i}] {d}: tracking_iter_ms {vals[0]!r} mapping_iter_ms {vals[1]!r}",
                  flush=True)
    print(json.dumps({"device": smi.stdout.strip(), "deterministic": args.deterministic,
                      "kernels_ms": kern, "last_differs": last, "reference": ref,
                      "slam_iter_ms": slam}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
