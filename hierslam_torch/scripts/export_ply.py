"""Export a finished run's Gaussian map to PLY.

    python3 -m hierslam_torch.scripts.export_ply RUN_DIR [--semantic] [--level N]
        [--num-semantic N ...] [--out x.ply]

The JAX package's ``scripts/export_ply.py`` contract; the files are the
same to the byte.
"""
import argparse
import os


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("run_dir")
    parser.add_argument("--semantic", action="store_true")
    parser.add_argument("--level", type=int, default=None,
                        help="color by this tree level instead of leaves")
    parser.add_argument("--num-semantic", type=int, nargs="*", default=None,
                        help="per-level class counts + leaf count (tree mode)")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)

    from hierslam_torch.datasets.tree import label_colormap
    from hierslam_torch.export import ply as ply_lib
    from hierslam_torch.utils import io as uio

    params = uio.load_params(os.path.join(args.run_dir, "params.npz"))
    out = args.out or os.path.join(
        args.run_dir, "splat_semantic.ply" if args.semantic else "splat.ply")
    if args.semantic:
        dec = os.path.join(args.run_dir, "semantic_decoder.npz")
        mlp = uio.load_semantic_decoder(dec) if os.path.isfile(dec) else None
        ply_lib.export_ply_semantic(params, out, label_colormap(512),
                                    num_semantic=args.num_semantic, mlp=mlp, level=args.level)
    else:
        ply_lib.export_ply(params, out)
    print("wrote", out)
    return out


if __name__ == "__main__":
    main()
