"""Replay a finished run's reconstruction.

    python3 -m hierslam_torch.scripts.visualize CONFIG [--params PARAMS.npz]
        [--mode online|final] [--every N] [--frames-only] [--semantic]
        [--viz-scale S] [--device cpu]

The JAX package's CLI contract (``scripts/visualize.py``): with open3d
installed and without ``--frames-only``, the interactive Open3D replay;
otherwise PNG frames of the map along the trajectory into
``workdir/run_name/viz``.  ``--semantic`` decodes the semantic channels
with the run's ``semantic_decoder.npz`` when present, else the per-level
tree decode of the config's ``num_semantic``.  ``--device`` (default
``cuda``) picks where the renders run.
"""
import argparse
import os

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("config")
    ap.add_argument("--params", default=None, help="path to params.npz")
    ap.add_argument("--mode", choices=("online", "final"), default="online")
    ap.add_argument("--every", type=int, default=10)
    ap.add_argument("--frames-only", action="store_true")
    ap.add_argument("--semantic", action="store_true")
    ap.add_argument("--viz-scale", type=float, default=0.5)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from hierslam_torch import resolve_device
    from hierslam_torch.config import load_config

    resolve_device(args.device)
    config = load_config(args.config)
    run_dir = os.path.join(config["workdir"], config["run_name"])
    path = args.params or os.path.join(run_dir, "params.npz")
    params = dict(np.load(path))
    online = args.mode == "online"

    # the decoder saved beside the run when present, a deterministic
    # palette in every case
    mlp, colormap, num_semantic = None, None, None
    if args.semantic and "semantic" in params:
        from hierslam_torch.datasets.tree import label_colormap

        dec = os.path.join(run_dir, "semantic_decoder.npz")
        if os.path.isfile(dec):
            mlp = dict(np.load(dec))
            n_cls = mlp["w"].shape[0]
        else:
            ns = config.get("data", {}).get("num_semantic")
            num_semantic = ns if isinstance(ns, (list, tuple)) else None
            n_cls = (ns[-1] if isinstance(ns, (list, tuple))
                     else int(params["semantic"].shape[1]))
        colormap = label_colormap(max(int(n_cls), 2))

    kw = dict(every=args.every, viz_scale=args.viz_scale, online=online,
              semantic=args.semantic, mlp=mlp, colormap=colormap, num_semantic=num_semantic,
              device=args.device)
    try:
        if args.frames_only:
            raise ImportError("frames-only requested")
        import open3d  # noqa: F401

        from hierslam_torch.viz.recon import interactive_replay

        interactive_replay(params, config, **kw)
        return None
    except ImportError:
        from hierslam_torch.viz.recon import render_trajectory_frames

        out = render_trajectory_frames(params, os.path.join(run_dir, "viz"), config, **kw)
        print(f"wrote replay frames to {out}")
        return out


if __name__ == "__main__":
    main()
