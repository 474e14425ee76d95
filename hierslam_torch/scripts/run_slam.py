"""Run SLAM from a Python config module, then the final eval.

    python3 -m hierslam_torch.scripts.run_slam configs/replica/hierslam_semantic_run.py
    python3 -m hierslam_torch.scripts.run_slam CONFIG --no-eval --device cpu

The JAX package's CLI contract (``scripts/run_slam.py``): the run's
results directory is ``workdir/run_name``, a copy of the config goes there
as ``config.py`` (unless the run resumes from a checkpoint), the eval
prints its header and row, and the total time is printed last.
``--device`` (default ``cuda``) picks where the run goes.
"""
import argparse
import os
import shutil
import time


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("experiment", type=str, help="Path to config .py file")
    parser.add_argument("--no-eval", action="store_true")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from hierslam_torch.config import load_config
    from hierslam_torch.slam.pipeline import run_slam
    from hierslam_torch.utils.io import seed_everything

    config = load_config(args.experiment)
    seed_everything(config.get("seed", 0))
    results_dir = os.path.join(config["workdir"], config["run_name"])
    config["results_dir"] = results_dir
    if not config.get("load_checkpoint", False):
        os.makedirs(results_dir, exist_ok=True)
        shutil.copy(args.experiment, os.path.join(results_dir, "config.py"))

    t0 = time.time()
    out = run_slam(config, do_eval=not args.no_eval, device=args.device)
    dt = time.time() - t0
    print(f"total SLAM time: {dt:.1f}s ({dt/60:.2f} min)")
    return out


if __name__ == "__main__":
    main()
