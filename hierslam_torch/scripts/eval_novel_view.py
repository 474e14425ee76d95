"""Evaluate a finished run again, from its files.

    python3 -m hierslam_torch.scripts.eval_novel_view configs/replica/hierslam_semantic_run.py
    python3 -m hierslam_torch.scripts.eval_novel_view CONFIG --device cpu

The JAX package's CLI contract (``scripts/eval_novel_view.py``): reload
``params.npz`` (and ``semantic_decoder.npz`` when present) from
``workdir/run_name``, rebuild the config's dataset (``use_train_split`` is
passed only to ``replicav2``), then on the train split run the final eval
with ``save_frames`` (per-frame PNGs, the semantic figures) into
``workdir/run_name/eval``, or else the novel-view eval of the held-out
views.  ``--device`` (default ``cuda``) picks where the renders run.
"""
import argparse
import os


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("experiment", type=str, help="Path to config .py file")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from hierslam_torch import resolve_device
    from hierslam_torch.config import apply_defaults, load_config
    from hierslam_torch.datasets import get_dataset
    from hierslam_torch.datasets.base import load_dataset_config
    from hierslam_torch.eval.runner import run_final_eval, run_nvs_eval
    from hierslam_torch.utils import io as uio

    resolve_device(args.device)
    config = apply_defaults(load_config(args.experiment))
    results_dir = os.path.join(config["workdir"], config["run_name"])
    eval_dir = os.path.join(results_dir, "eval")
    params_np = uio.load_params(os.path.join(results_dir, "params.npz"))
    dec_path = os.path.join(results_dir, "semantic_decoder.npz")
    mlp = uio.load_semantic_decoder(dec_path) if os.path.isfile(dec_path) else None

    dc = config["data"]
    if "gradslam_data_cfg" in dc:
        data_cfg = {**load_dataset_config(dc["gradslam_data_cfg"]), **dc}
    else:
        data_cfg = dict(dc)
    data_cfg["results_dir"] = results_dir
    use_train = dc.get("use_train_split", True)
    dataset = get_dataset(
        config_dict=data_cfg, basedir=dc["basedir"], sequence=os.path.basename(dc["sequence"]),
        start=dc["start"], end=dc["end"], stride=dc["stride"],
        desired_height=dc["desired_image_height"], desired_width=dc["desired_image_width"],
        relative_pose=True,
        **({"use_train_split": use_train} if "replicav2" in data_cfg["dataset_name"] else {}),
    )
    if use_train:
        return run_final_eval(dataset, params_np, config, eval_dir, mlp=mlp, save_frames=True,
                              device=args.device)
    return run_nvs_eval(dataset, params_np, config, eval_dir,
                        sil_thres=config["mapping"]["sil_thres"], device=args.device)


if __name__ == "__main__":
    main()
