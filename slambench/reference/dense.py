"""The plain reference of the steps that ``correct`` checks, written from the
method (3D Gaussian splatting as SplaTAM and Hier-SLAM run it) and not from
the program: no tile budget, capacity class, pair stream, cached list or
amortised binning; plain ``torch.optim.Adam``.

Rendering: each live gaussian is projected (EWA with the 0.3 px low-pass,
a 3-sigma radius from the larger eigenvalue, culled at z <= 0.2), emits
one pair for every 16 x 16 tile its radius rectangle covers, and every
pixel blends all pairs of its tile front to back in depth order (ties by
row): ``alpha = min(0.99, o exp(-q / 2))``, skipped where q < 0 or alpha <
1/255, stopping before the transmittance would fall under 1e-4.  The blend
runs over blocks of tiles padded to their longest list, each block
recomputed in the backward pass (``torch.utils.checkpoint``), so that the
whole frame fits at any map size.  Gradients are autograd's.
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as Fn
from torch.utils.checkpoint import checkpoint

TILE = 16
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_MIN = 1e-4
NEAR_Z = 0.2
LOW_PASS = 0.3
BLOCK_ELEMS = 1 << 25   # (tile, pixel, pair) elements of one blend block
SEM_LEVEL_WEIGHT, SEM_LEAF_WEIGHT, DECODER_FROM_ITER, DECODER_LR = 1.0, 5.0, 14, 5e-4


class View(NamedTuple):
    W: int
    H: int
    fx: float
    fy: float
    cx: float
    cy: float


def rotation(q: torch.Tensor) -> torch.Tensor:
    """The rotation of the quaternion (w, x, y, z), normalised here."""
    w, x, y, z = (q / q.norm().clamp_min(1e-12)).unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)]),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)]),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)])])


def to_camera(means: torch.Tensor, q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """World points into the camera of world-to-camera pose (q, t)."""
    return means @ rotation(q).T + t


def project(mc: torch.Tensor, scale: torch.Tensor, view: View):
    """Screen mean, conic, depth, radius and validity of isotropic gaussians
    at camera-frame means ``mc`` [N, 3] with scales ``scale`` [N]."""
    x, y, z = mc.unbind(-1)
    zs = torch.where(z == 0, torch.ones_like(z), z)
    u = torch.clamp(x / zs, -1.3 * view.W / (2 * view.fx), 1.3 * view.W / (2 * view.fx))
    v = torch.clamp(y / zs, -1.3 * view.H / (2 * view.fy), 1.3 * view.H / (2 * view.fy))
    ax, ay, s2 = view.fx / zs, view.fy / zs, scale * scale
    # s^2 J J^T + 0.3 I, J the projection's Jacobian at the (clamped) mean
    cxx = s2 * ax * ax * (1 + u * u) + LOW_PASS
    cxy = s2 * ax * ay * u * v
    cyy = s2 * ay * ay * (1 + v * v) + LOW_PASS
    det = cxx * cyy - cxy * cxy
    ok = det != 0
    det = torch.where(ok, det, torch.ones_like(det))
    conic = torch.stack([cyy / det, -cxy / det, cxx / det], -1)
    px = view.fx * x / zs + view.cx - 0.5     # pixel i's centre is at i
    py = view.fy * y / zs + view.cy - 0.5
    with torch.no_grad():
        mid = 0.5 * (cxx + cyy)
        radius = torch.ceil(3.0 * torch.sqrt(mid + torch.sqrt(torch.clamp_min(mid * mid - det,
                                                                               0.1))))
    return px, py, conic, z, radius, ok & (z > NEAR_Z)


@torch.no_grad()
def tile_pairs(px, py, radius, depth, valid, gx: int, gy: int):
    """(tile, row) of every tile each valid gaussian's radius rectangle
    covers, ordered by tile, then depth, then row."""
    def edge(c, n):
        return torch.clamp(torch.floor(c / TILE), 0, n).long()
    x0, x1 = edge(px - radius, gx), edge(px + radius + TILE - 1, gx)
    y0, y1 = edge(py - radius, gy), edge(py + radius + TILE - 1, gy)
    n = torch.where(valid, (x1 - x0) * (y1 - y0), torch.zeros_like(x0))
    rows = torch.nonzero(n > 0)[:, 0]
    cnt = n[rows]
    row = torch.repeat_interleave(rows, cnt)
    j = torch.arange(row.shape[0], device=row.device) - torch.repeat_interleave(
        torch.cumsum(cnt, 0) - cnt, cnt)
    wide = (x1 - x0)[row]
    tile = (y0[row] + j // wide) * gx + x0[row] + j % wide
    o = torch.argsort(depth[row], stable=True)
    tile, row = tile[o], row[o]
    o = torch.argsort(tile, stable=True)
    return tile[o], row[o]


def _blend(attr, feat, ok, pxl, pyl):
    """One block: ``attr`` [B, L, 6] (x, y, conic a b c, opacity) and
    ``feat`` [B, L, C] of each tile's depth-ordered pairs, ``ok`` [B, L],
    pixel centres [B, P] -> (blended [B, P, C], final transmittance [B, P])."""
    dx = attr[:, None, :, 0] - pxl[:, :, None]
    dy = attr[:, None, :, 1] - pyl[:, :, None]
    q = (-0.5 * (attr[:, None, :, 2] * dx * dx + attr[:, None, :, 4] * dy * dy)
         - attr[:, None, :, 3] * dx * dy)
    alpha = torch.clamp_max(attr[:, None, :, 5] * torch.exp(torch.clamp_max(q, 0.0)), ALPHA_MAX)
    a = torch.where((q <= 0) & (alpha >= ALPHA_MIN) & ok[:, None, :], alpha,
                    torch.zeros_like(alpha))
    after = torch.cumprod(1.0 - a, -1)
    before = torch.cat([torch.ones_like(after[..., :1]), after[..., :-1]], -1)
    kept = after >= T_MIN     # a prefix: the transmittance only falls
    acc = torch.einsum("bpl,blc->bpc", a * before * kept, feat)
    return acc, torch.where(kept, after, torch.ones_like(after)).amin(-1)


def render(view: View, mc, scale, opacity, feats: Optional[torch.Tensor], alive=None):
    """Blend the gaussians at camera-frame means ``mc``: -> (channels [C+1,
    H, W]: the C feature channels, then depth; silhouette [H, W], one less
    the final transmittance)."""
    px, py, conic, z, radius, valid = project(mc, scale, view)
    if alive is not None:
        valid = valid & alive
    gx, gy = -(-view.W // TILE), -(-view.H // TILE)
    tile, row = tile_pairs(px, py, radius, z, valid, gx, gy)
    attr = torch.cat([px[:, None], py[:, None], conic, opacity[:, None]], -1)
    feat = torch.cat(([feats] if feats is not None else []) + [z[:, None]], -1)
    n_tiles, P, dev = gx * gy, TILE * TILE, mc.device
    counts = torch.bincount(tile, minlength=n_tiles)
    starts = torch.cumsum(counts, 0) - counts
    order = torch.argsort(counts, descending=True, stable=True)
    counts_h = counts[order].tolist()
    lin = torch.arange(P, device=dev)
    grad = torch.is_grad_enabled() and (attr.requires_grad or feat.requires_grad)
    ids, accs, ends = [], [], []
    i, n_live = 0, sum(1 for c in counts_h if c > 0)
    while i < n_live:
        L = counts_h[i]
        tb = order[i:min(n_live, i + max(1, BLOCK_ELEMS // (P * L)))]
        i += tb.shape[0]
        k = torch.arange(L, device=dev)
        ok = k[None, :] < counts[tb][:, None]
        r = row[torch.where(ok, starts[tb][:, None] + k[None, :], torch.zeros_like(k)[None])]
        pxl = (((tb % gx) * TILE)[:, None] + lin % TILE).float()
        pyl = (((tb // gx) * TILE)[:, None] + lin // TILE).float()
        args = (attr[r], feat[r], ok, pxl, pyl)
        acc, end = (checkpoint(_blend, *args, use_reentrant=False) if grad else _blend(*args))
        ids.append(tb)
        accs.append(acc)
        ends.append(end)
    C = feat.shape[1]
    acc = torch.zeros((n_tiles, P, C), device=dev, dtype=feat.dtype)
    end = torch.ones((n_tiles, P), device=dev, dtype=feat.dtype)
    if ids:
        idx = torch.cat(ids)
        acc = acc.index_copy(0, idx, torch.cat(accs))
        end = end.index_copy(0, idx, torch.cat(ends))

    def image(x):
        x = x.reshape(gy, gx, TILE, TILE, -1).permute(4, 0, 2, 1, 3)
        return x.reshape(x.shape[0], gy * TILE, gx * TILE)[:, :view.H, :view.W]
    return image(acc), 1.0 - image(end[..., None])[0]


# ---- losses -------------------------------------------------------------

def lower_median(x: torch.Tensor) -> torch.Tensor:
    flat = x.reshape(-1)
    return torch.kthvalue(flat, (flat.shape[0] - 1) // 2 + 1).values


def depth_mask(depth, depth_gt, ignore_outliers: bool):
    """Pixels the depth terms count: a measured depth, a number rendered,
    and with ``ignore_outliers`` an error under ten times the median."""
    with torch.no_grad():
        mask = depth_gt > 0
        if ignore_outliers:
            err = torch.abs(depth_gt - depth) * mask
            mask = mask & (err < 10 * lower_median(err))
        return mask & ~torch.isnan(depth)


def half_rows(*xs):
    """The top half of the image rows of each [..., H, W] tensor (the
    planted fault: half of the batch left out, the mean over the rest)."""
    return [x[..., :x.shape[-2] // 2, :] for x in xs]


def tracking_loss(im, depth, sil, im_gt, depth_gt, tc: Dict, half: bool = False):
    """Sums over the pixels whose silhouette passes ``sil_thres``."""
    if half:
        im, depth, sil, im_gt, depth_gt = half_rows(im, depth, sil, im_gt, depth_gt)
    mask = depth_mask(depth, depth_gt, tc["ignore_outlier_depth_loss"])
    if tc["use_sil_for_loss"]:
        mask = mask & (sil > tc["sil_thres"])
    l_depth = torch.sum(torch.abs(depth_gt - depth) * mask)
    if tc["use_sil_for_loss"] or tc["ignore_outlier_depth_loss"]:
        l_im = torch.sum(torch.abs(im_gt - im) * mask)
    else:
        l_im = torch.sum(torch.abs(im_gt - im))
    w = tc["loss_weights"]
    return w["im"] * l_im + w["depth"] * l_depth


def ssim(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean SSIM of two [C, H, W] images: 11 x 11 gaussian window, sigma
    1.5, zero padding, C1 = 0.01^2, C2 = 0.03^2.  The window is separable:
    each filter is a product with a banded [H, H] and a banded [W, W]
    matrix, the band cut at the borders (the zero padding)."""
    g = torch.exp(-(torch.arange(11, dtype=a.dtype, device=a.device) - 5) ** 2 / (2 * 1.5 ** 2))
    g = g / g.sum()

    def band(n):
        i = torch.arange(n, device=a.device)
        d = i[None, :] - i[:, None] + 5
        return torch.where((d >= 0) & (d <= 10), g[d.clamp(0, 10)], torch.zeros((), dtype=a.dtype,
                                                                              device=a.device))
    gh, gw = band(a.shape[-2]), band(a.shape[-1])

    def f(x):
        return gh @ x @ gw.T
    mu1, mu2 = f(a), f(b)
    s11, s22, s12 = f(a * a) - mu1 * mu1, f(b * b) - mu2 * mu2, f(a * b) - mu1 * mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return (((2 * mu1 * mu2 + c1) * (2 * s12 + c2))
            / ((mu1 * mu1 + mu2 * mu2 + c1) * (s11 + s22 + c2))).mean()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of channel-major logits [C, H, W] at labels [H, W]."""
    return Fn.cross_entropy(logits[None], labels[None].long())


def mapping_loss(im, depth, sem, im_gt, depth_gt, labels, decoder, it: int, mc: Dict,
                 levels: Sequence[int], half: bool = False):
    """Depth as a masked mean, colour 0.8 L1 + 0.2 (1 - SSIM), and the
    semantic cross-entropy of each tree level, with the leaf's through the
    1x1 decoder from iteration 14 on."""
    if half:
        im, depth, im_gt, depth_gt = half_rows(im, depth, im_gt, depth_gt)
        sem, labels = (None, None) if sem is None else half_rows(sem, labels)
    mask = depth_mask(depth, depth_gt, mc["ignore_outlier_depth_loss"])
    l_depth = torch.sum(torch.abs(depth_gt - depth) * mask) / mask.sum().clamp_min(1)
    l_im = 0.8 * torch.mean(torch.abs(im - im_gt)) + 0.2 * (1.0 - ssim(im, im_gt))
    w = mc["loss_weights"]
    loss = w["im"] * l_im + w["depth"] * l_depth
    if levels and labels is not None:
        bounds = [0] + list(torch.cumsum(torch.tensor(levels), 0).tolist())
        sem_loss = SEM_LEVEL_WEIGHT * sum(cross_entropy(sem[a:b], labels[i])
                                          for i, (a, b) in enumerate(zip(bounds, bounds[1:])))
        if decoder is not None and it >= DECODER_FROM_ITER:
            leaf = torch.einsum("shw,ls->lhw", sem, decoder["w"]) + decoder["b"][:, None, None]
            sem_loss = sem_loss + SEM_LEAF_WEIGHT * cross_entropy(leaf, labels[-1])
        loss = loss + w.get("sem", 0.0) * sem_loss
    return loss


# ---- the three phases ---------------------------------------------------

def propagate(q: torch.Tensor, t: torch.Tensor, frame: int):
    """The start pose of ``frame`` from poses [4, n], [3, n]: constant
    velocity in the quaternion and the translation."""
    q1 = q[:, frame - 1] / q[:, frame - 1].norm()
    q2 = q[:, frame - 2] / q[:, frame - 2].norm()
    q0 = q1 + (q1 - q2)
    return q0 / q0.norm(), t[:, frame - 1] + (t[:, frame - 1] - t[:, frame - 2])


def track(view: View, m: Dict, q0, t0, im_gt, depth_gt, tc: Dict, half: bool = False):
    """Adam on the pose for ``tc['num_iters']`` steps, each loss taken before
    its step; the pose after the step of the lowest loss is kept.  -> (the
    losses, the lowest, its pose)."""
    q = q0.clone().requires_grad_(True)
    t = t0.clone().requires_grad_(True)
    opt = torch.optim.Adam([{"params": [q], "lr": tc["lrs"]["cam_unnorm_rots"]},
                            {"params": [t], "lr": tc["lrs"]["cam_trans"]}], eps=1e-8)
    scale, opac = torch.exp(m["log_scales"][:, 0]), torch.sigmoid(m["logit_opacities"][:, 0])
    losses, best, bq, bt = [], math.inf, q0.clone(), t0.clone()
    for _ in range(int(tc["num_iters"])):
        opt.zero_grad()
        ch, sil = render(view, to_camera(m["means3D"], q, t), scale, opac, m["rgb_colors"])
        loss = tracking_loss(ch[:3], ch[3], sil, im_gt, depth_gt, tc, half)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        if losses[-1] < best:
            best, bq, bt = losses[-1], q.detach().clone(), t.detach().clone()
    return losses, best, bq, bt


@torch.no_grad()
def densify(view: View, m: Dict, q, t, im_gt, depth_gt, sil_thres: float, n_sem: int,
            generator: torch.Generator) -> Dict:
    """The new gaussians of a frame: a pixel with a measured depth where the
    silhouette is under ``sil_thres`` or the map lies behind the measured
    depth by more than 50 median errors gives one, at its back-projected
    depth, with its colour, scale z / mean focal, opacity 1/2, identity
    rotation and semantic features U[0, 1) drawn from ``generator`` for
    every pixel.  -> {field: [n, ...]} in pixel order."""
    ch, sil = render(view, to_camera(m["means3D"], q, t), torch.exp(m["log_scales"][:, 0]),
                     torch.sigmoid(m["logit_opacities"][:, 0]), None)
    depth = ch[0]
    err = torch.abs(depth_gt - depth) * (depth_gt > 0)
    grow = (sil < sil_thres) | ((depth > depth_gt) & (err > 50 * lower_median(err)))
    pick = (grow & (depth_gt > 0)).reshape(-1)
    dev, H, W = depth_gt.device, view.H, view.W
    xs = (torch.arange(W, dtype=torch.float32, device=dev) - view.cx) / view.fx
    ys = (torch.arange(H, dtype=torch.float32, device=dev) - view.cy) / view.fy
    z = depth_gt.reshape(-1)
    cam = torch.stack([xs[None, :].expand(H, W).reshape(-1) * z,
                       ys[:, None].expand(H, W).reshape(-1) * z, z], -1)
    R = rotation(q)
    out = {"means3D": ((cam - t) @ R)[pick],
           "rgb_colors": im_gt.reshape(3, -1).T[pick],
           "logit_opacities": torch.zeros((int(pick.sum()), 1), device=dev),
           "log_scales": (0.5 * torch.log(torch.clamp_min((z / (0.5 * (view.fx + view.fy))) ** 2,
                                                          1e-12)))[pick][:, None]}
    if n_sem:
        out["semantic"] = torch.rand((H * W, n_sem), generator=generator,
                                     device=generator.device).to(dev)[pick]
    return out


LEAVES = ("means3D", "log_scales", "logit_opacities", "rgb_colors", "semantic")


def map_phase(view: View, m: Dict, frames: List, poses: List, rand_idx, decoder, dec_state,
              mc: Dict, levels: Sequence[int], scene_radius: float, half: bool = False):
    """Adam on the map over ``mc['num_iters']`` steps, each on the window
    frame ``rand_idx[it]`` at its pose; gaussians under the opacity
    threshold or wider than a tenth of the scene radius are removed (after
    the backward, before the step) on the prune schedule.  The decoder
    steps every iteration, with a zero gradient before it enters the loss.
    ``m``: the live gaussians; ``dec_state``: (first moments, second
    moments, steps) of the decoder's Adam.  -> (map, alive [N], decoder,
    losses, the first step's gradient norm of each leaf)."""
    leaves = {k: m[k].clone().requires_grad_(True) for k in LEAVES if k in m}
    lrs = {k: float(mc["lrs"].get(k, 0.0)) for k in leaves}
    opt = torch.optim.Adam([{"params": [x], "lr": lrs[k]} for k, x in leaves.items()],
                           eps=1e-15)
    dec, dopt = None, None
    if decoder is not None:
        dec = {k: x.clone().requires_grad_(True) for k, x in decoder.items()}
        dopt = torch.optim.Adam(list(dec.values()), lr=DECODER_LR, eps=1e-8)
        mu, nu, steps = dec_state
        if steps:
            for k, x in dec.items():
                dopt.state[x] = {"step": torch.tensor(float(steps)), "exp_avg": mu[k].clone(),
                                 "exp_avg_sq": nu[k].clone()}
    alive = torch.ones(leaves["means3D"].shape[0], dtype=torch.bool,
                       device=leaves["means3D"].device)
    pd = mc.get("pruning_dict", {}) if mc.get("prune_gaussians", False) else {}
    losses, first = [], {}
    for it, k in enumerate(int(i) for i in rand_idx[:int(mc["num_iters"])]):
        im_gt, depth_gt, labels = frames[k]
        opt.zero_grad()
        if dopt is not None:
            dopt.zero_grad()
        feats = torch.cat([leaves["rgb_colors"]] + ([leaves["semantic"]] if levels else []), -1)
        ch, _ = render(view, to_camera(leaves["means3D"], *poses[k]),
                       torch.exp(leaves["log_scales"][:, 0]),
                       torch.sigmoid(leaves["logit_opacities"][:, 0]), feats, alive)
        loss = mapping_loss(ch[:3], ch[-1], ch[3:-1] if levels else None, im_gt, depth_gt,
                            labels, dec, it, mc, levels, half)
        loss.backward()
        if dec is not None:
            for x in dec.values():
                if x.grad is None:
                    x.grad = torch.zeros_like(x)
        if it == 0:
            first = {n: float(x.grad.double().norm()) for n, x in leaves.items()}
            first.update({"decoder." + n: float(x.grad.double().norm())
                          for n, x in (dec or {}).items()})
        if pd and pd["start_after"] <= it <= pd["stop_after"] and it % pd["prune_every"] == 0:
            thr = (pd["final_removal_opacity_threshold"] if it == pd["stop_after"]
                   else pd["removal_opacity_threshold"])
            with torch.no_grad():
                gone = alive & (torch.sigmoid(leaves["logit_opacities"][:, 0]) < thr)
                if it >= pd["remove_big_after"]:
                    gone |= alive & (torch.exp(leaves["log_scales"][:, 0]) > 0.1 * scene_radius)
                alive &= ~gone
                for x in leaves.values():
                    for s in ("exp_avg", "exp_avg_sq"):
                        if s in opt.state.get(x, {}):
                            opt.state[x][s][gone] = 0.0
        opt.step()
        if dopt is not None:
            dopt.step()
        losses.append(float(loss.detach()))
    out = {k: x.detach() for k, x in leaves.items()}
    return (out, alive, None if dec is None else {k: x.detach() for k, x in dec.items()},
            losses, first)
