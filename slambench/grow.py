"""How large and how dense the program's own map grows on the benchmark's
room, to size a traffic mix's seeded map (on the card; the benchmark's
runs do not run this).

    python3 slambench/grow.py --workload CELL [--seed N]

Runs ``SLAMRunner`` with the cell's configuration from frame 0 up to the
traffic's resume frame on the benchmark's dataset and prints one JSON
line: the live gaussians at the resume frame, the pairs each mapping
phase's binnings dropped, and quantiles of the map's opacity and scale,
beside the same quantiles of the map the benchmark seeds for that frame.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from slambench import cells, harness  # noqa: E402

Q = torch.tensor([0.1, 0.25, 0.5, 0.75, 0.9])


def quantiles(logit, log_scale):
    """Quantiles of the opacity and of the scale (m) of a map."""
    return dict(opacity=torch.quantile(torch.sigmoid(logit.float().cpu())[:2_000_000], Q).tolist(),
                scale=torch.quantile(torch.exp(log_scale.float().cpu())[:2_000_000], Q).tolist())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    from hierslam_torch.slam.pipeline import SLAMRunner

    spec = cells.cell_spec(args.workload)
    dev = torch.device("cuda", 0)
    print(f"[grow] {torch.cuda.get_device_name(dev)}, nvidia-smi: {harness.power_limit()}",
          flush=True)
    from hierslam_torch.ops import kernels
    kernels.build()
    traffic, conf = spec["traffic"], spec["config"]
    S = int(traffic["resume_frame"])
    ds = cells.RoomSequence(conf["frames"], traffic["arc_frames"], S, dev)
    work = os.path.join(os.environ.get("TMPDIR") or harness.OUT_DIR, "slambench_grow")
    cfg = cells.run_config(spec, args.seed, work)
    cfg.update(load_checkpoint=False, checkpoint_time_idx=0)
    runner = SLAMRunner(cfg, dataset=ds, device=dev)
    dropped = []
    mapper = runner.mapper

    def map_phase(*a, **k):
        res = mapper(*a, **k)
        dropped.append(int(res[4]["n_map_bin_dropped"].max()))
        return res
    runner.mapper = map_phase
    t0 = time.time()
    for t in range(S):
        runner.step(t, runner._load_frame(t))
    act = runner.variables["active"]
    p = runner.params
    grown = quantiles(p["logit_opacities"][act][:, 0], p["log_scales"][act][:, 0])
    n_sem = int(sum(ds.num_semantic[:-1]))
    seeded = cells.make_map(ds, int(traffic["map_gaussians"]), S, args.seed, n_sem)
    print(json.dumps(dict(cell=args.workload, frames=S, n_active=int(act.sum()),
                          seconds=time.time() - t0, map_dropped=dropped, grown=grown,
                          seeded=quantiles(seeded["logit_opacities"][:, 0],
                                           seeded["log_scales"][:, 0]),
                          seeded_n=int(traffic["map_gaussians"]))), flush=True)


if __name__ == "__main__":
    main()
