"""The port stands alone: no module of ``hierslam_torch`` and not
``chip_smoke.py`` imports ``jax`` or ``hierslam_tpu``, and none imports
``cv2``, ``imageio``, ``yaml`` or ``PIL`` (checked on the source, so a lazy
import inside a function counts too; matplotlib and tqdm are imported only
inside a gate); and every entry point refuses to run without CUDA unless
the caller passes ``device="cpu"``."""
import ast
import glob
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "hierslam_tpu", "cv2", "imageio", "yaml", "PIL")
PORT_FILES = sorted(glob.glob(os.path.join(ROOT, "hierslam_torch", "**", "*.py"), recursive=True))


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                roots.add(str(node.args[0].value).split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES + [os.path.join(ROOT, "chip_smoke.py")],
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_import(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path} imports {bad}"


def _entry_points():
    from hierslam_torch.core.camera import intrinsics_matrix, setup_camera
    from hierslam_torch.ops.rasterize import RasterConfig
    from hierslam_torch.slam.losses import LossConfig
    from hierslam_torch.slam.mapping import PruneConfig, make_densifier, make_mapper
    from hierslam_torch.slam.tracking import make_tracker

    cam = setup_camera(32, 24, intrinsics_matrix(20.0, 20.0, 16.0, 12.0), np.eye(4))
    rc = RasterConfig()
    return {
        "make_tracker": lambda **kw: make_tracker(cam, LossConfig(), rc, 1e-3, 1e-3, 2, **kw),
        "make_mapper": lambda **kw: make_mapper(cam, LossConfig(), rc, {}, 2, PruneConfig(),
                                                **kw),
        "make_mapper_stream": lambda **kw: make_mapper(
            cam, LossConfig(), RasterConfig(backend="stream"), {}, 2, PruneConfig(), **kw),
        "make_densifier": lambda **kw: make_densifier(cam, rc, 0.5, 0, **kw),
    }


def _disk_entry_points(tmp_path):
    """The entry points that read a sequence from disk or a finished map,
    on a fabricated Replica sequence, called with ``**kw``."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from fabricate import fabricate_replica
    from test_e2e import small_config

    from hierslam_torch.eval.runner import run_final_eval, run_nvs_eval
    from hierslam_torch.slam.pipeline import SLAMRunner, run_slam

    basedir, seq, _ = fabricate_replica(str(tmp_path / "d"), n_frames=2, semantic=True)
    cfg = small_config(basedir, seq, workdir=str(tmp_path / "w"))
    cfg["raster"]["backend"] = "pallas"
    n = 50
    pn = {"means3D": np.random.default_rng(0).uniform(-1, 1, (n, 3)) + [0, 0, 2.5],
          "rgb_colors": np.full((n, 3), 0.5), "unnorm_rotations": np.tile([1.0, 0, 0, 0], (n, 1)),
          "logit_opacities": np.zeros((n, 1)), "log_scales": np.full((n, 1), -3.0),
          "cam_unnorm_rots": np.tile(np.array([1.0, 0, 0, 0])[None, :, None], (1, 1, 2)),
          "cam_trans": np.zeros((1, 3, 2)), "w2c": np.eye(4),
          "gt_w2c_all_frames": np.tile(np.eye(4), (2, 1, 1))}
    pn = {k: np.asarray(v, np.float32) for k, v in pn.items()}

    def dataset():
        return SLAMRunner(cfg, device="cpu").dataset

    return {
        "SLAMRunner_config": lambda **kw: SLAMRunner(cfg, **kw),
        "run_slam": lambda **kw: run_slam(dict(cfg, data=dict(cfg["data"], num_frames=1)),
                                          **kw),
        "run_final_eval": lambda **kw: run_final_eval(dataset(), pn, cfg, str(tmp_path / "e"),
                                                      **kw),
        "run_nvs_eval": lambda **kw: run_nvs_eval(dataset(), pn, cfg, str(tmp_path / "n"),
                                                  **kw),
    }


@pytest.mark.parametrize("name", ["make_tracker", "make_mapper", "make_mapper_stream",
                                  "make_densifier", "SLAMRunner", "SLAMRunner_config",
                                  "run_slam", "run_final_eval", "run_nvs_eval"])
def test_entry_points_need_cuda_unless_cpu(name, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    if name == "SLAMRunner":
        from hierslam_torch.slam.pipeline import SLAMRunner

        with pytest.raises(RuntimeError, match="CUDA is not available"):
            SLAMRunner({"workdir": str(tmp_path), "run_name": "x"}, dataset=[])
        return
    if name in ("SLAMRunner_config", "run_slam", "run_final_eval", "run_nvs_eval"):
        run = _disk_entry_points(tmp_path)[name]
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run()
        assert run(device="cpu") is not None
        return
    make = _entry_points()[name]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make()
    assert callable(make(device="cpu"))
