"""The dense reference against the program's plain render where no budget
binds, and the trace reader's frames against a launch from another thread."""
import numpy as np
import torch

from slambench.frozen import trace
from slambench.reference import dense as D


def test_dense_render_equals_the_programs_plain_render_without_budgets():
    from hierslam_torch.core.camera import setup_camera
    from hierslam_torch.ops.rasterize import RasterConfig, rasterize

    g = torch.Generator().manual_seed(3)
    W, H, f, N = 96, 64, 48.0, 3000
    means = torch.stack([torch.rand(N, generator=g) * 4 - 2, torch.rand(N, generator=g) * 3 - 1.5,
                         torch.rand(N, generator=g) * 3 + 1], -1)
    scale = torch.exp(torch.log(means[:, 2] / f) + 0.3 * torch.randn(N, generator=g))
    opac = torch.sigmoid(1.5 + torch.randn(N, generator=g))
    rgb = torch.rand((N, 3), generator=g)
    K = np.array([[f, 0, 47.5], [0, f, 31.5], [0, 0, 1]], np.float32)
    cfg = RasterConfig(backend="xla", bucket_spec=((-1, 4096),), max_per_tile=4096)
    out = rasterize(means, rgb, opac, scale[:, None], torch.tensor([[1.0, 0, 0, 0]]).expand(N, 4),
                    setup_camera(W, H, K, np.eye(4)), config=cfg, device=torch.device("cpu"))
    assert int(out.n_dropped) == 0
    ch, sil = D.render(D.View(W, H, f, f, 47.5, 31.5), means, scale, opac, rgb)
    assert torch.allclose(ch[:3], out.im, atol=2e-5)
    assert torch.allclose(ch[3], out.depth, atol=5e-5)
    assert torch.allclose(sil, out.final_opacity, atol=2e-5)


def test_dense_render_gradients_flow_to_the_pose():
    g = torch.Generator().manual_seed(4)
    N = 500
    means = torch.stack([torch.rand(N, generator=g) - 0.5, torch.rand(N, generator=g) - 0.5,
                         torch.rand(N, generator=g) + 1.5], -1)
    q = torch.tensor([1.0, 0.0, 0.0, 0.0], requires_grad=True)
    t = torch.zeros(3, requires_grad=True)
    ch, sil = D.render(D.View(32, 32, 30.0, 30.0, 15.5, 15.5), D.to_camera(means, q, t),
                       torch.full((N,), 0.02), torch.full((N,), 0.6),
                       torch.rand((N, 3), generator=g))
    (ch.sum() + sil.sum()).backward()
    assert q.grad.abs().sum() > 0 and t.grad.abs().sum() > 0


def test_a_launch_from_another_thread_belongs_to_no_frame(tmp_path):
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "slambench.frame8.track", "ts": 0,
         "dur": 100, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 10, "dur": 1,
         "tid": 1, "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 20, "dur": 1,
         "tid": 2, "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 30, "dur": 5, "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "b", "ts": 40, "dur": 5, "args": {"correlation": 2}},
    ]
    path = tmp_path / "t.json"
    path.write_text(__import__("json").dumps({"traceEvents": ev}))
    tr = trace.load(str(path))
    assert trace.launches_by_frame(tr) == {8: 1}
