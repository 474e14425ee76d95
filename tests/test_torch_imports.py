"""The port stands alone: no module of ``hierslam_torch`` and not
``chip_smoke.py`` imports ``jax`` or ``hierslam_tpu`` (checked on the
source, so a lazy import inside a function counts too), and every entry
point refuses to run without CUDA unless the caller passes ``device="cpu"``."""
import ast
import glob
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "hierslam_tpu")
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


@pytest.mark.parametrize("name", ["make_tracker", "make_mapper", "make_mapper_stream",
                                  "make_densifier", "SLAMRunner"])
def test_entry_points_need_cuda_unless_cpu(name, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    if name == "SLAMRunner":
        from hierslam_torch.slam.pipeline import SLAMRunner

        with pytest.raises(RuntimeError, match="CUDA is not available"):
            SLAMRunner({"workdir": str(tmp_path), "run_name": "x"}, dataset=[])
        return
    make = _entry_points()[name]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make()
    assert callable(make(device="cpu"))
