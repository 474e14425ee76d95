"""What decides ``correct``: the recorded steps worked out again by the dense
reference (``dense.py``).

During the warm-up the harness records what ``SLAMRunner.step`` hands to
and gets back from the first tracking phase, the first densify and the
first mapping phase of the run (``slambench/harness.py``, ``Recorder``).
After the window has closed, the program's state freed and
``memory_peak_bytes`` read, :func:`reference_observations` runs the same
phases through ``dense.py`` on the inputs the benchmark made itself:

* tracking: the seeded map, the checkpoint's poses, the start pose
  propagated at constant velocity, the frame rendered again;
* densify: the seeded map at the program's tracked pose of that frame
  (program state: the one input of this stage the benchmark did not make),
  with the program's generator state for the new rows' semantic draws;
* mapping: the program's live gaussians, decoder and its Adam state at the
  phase's start (program state), the window frames rendered again at the
  program's poses, the program's window and per-iteration frame choice.

:func:`numbers` compares, each as a share of the reference: the losses of
the first steps of each phase (``LOSS_STEPS``), the best loss of the
tracking phase (the one whose pose it keeps), the change of each leaf over
the phase (by the norm of the change, worst leaf, against the larger of
the leaf's and the median leaf's; a leaf whose first reference gradient is
under a thousandth of the median leaf's is left out), the count of
gaussians densify adds and the norm of each added field.  :func:`judge`
holds each number the cell's limits file names to its limit.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from slambench.reference import dense as D

NUMBERS = ("track_loss_gap", "track_best_gap", "track_change_gap", "dens_count_gap",
           "dens_fields_gap", "map_loss_gap", "map_change_gap")
LOSS_STEPS = {"track": 1, "map": 1}   # the steps whose losses are compared:
# tracking's third step reads Adam's sign-normalised first steps on near-zero pose
# gradients (PERF.md)


def frame_arrays(ds, t: int):
    """Frame ``t`` as ``SLAMRunner._load_frame`` hands it on: (colour
    [3, H, W] float32 in [0, 1], depth, labels or None)."""
    color, depth, _, _, labels = ds[t]
    im = np.ascontiguousarray(color.transpose(2, 0, 1) / 255.0, dtype=np.float32)
    return im, np.asarray(depth, np.float32), labels


def _frame(ds, t: int, dev):
    im, depth, labels = frame_arrays(ds, t)
    return (torch.as_tensor(im, device=dev), torch.as_tensor(depth, device=dev),
            None if labels is None else torch.as_tensor(labels.astype(np.int64), device=dev))


def _view(ds) -> D.View:
    f = ds.f
    return D.View(int(f["W"]), int(f["H"]), float(f["fx"]), float(f["fy"]), float(f["cx"]),
                  float(f["cy"]))


def _generator(state):
    g = torch.Generator()
    g.set_state(state)
    return g


def reference_observations(inp: Dict, prog: Dict, device, tf32: bool = False,
                           half: bool = False) -> Dict:
    """The observations of the recorded phases, computed by ``dense.py``.
    ``inp``: the benchmark's own inputs (``ds``, ``map``, ``cfg``, ``S``,
    ``rots``, ``trans``); ``prog``: the program's observations, for the
    program state the densify and mapping stages start from.  ``tf32``
    turns TF32 on for matrix products and convolutions (the control);
    ``half`` takes every loss over the top half of the image rows (a
    planted fault)."""
    was = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        return _observe(inp, prog, torch.device(device), half)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = was


def _observe(inp, prog, dev, half):
    ds, cfg = inp["ds"], inp["cfg"]
    view = _view(ds)
    seeded = {k: v.to(dev) for k, v in inp["map"].items()}
    out = {}
    if prog.get("track") is not None:
        t = prog["track"]["t"]
        q0, t0 = D.propagate(inp["rots"][0].to(dev), inp["trans"][0].to(dev), t)
        im, depth, _ = _frame(ds, t, dev)
        losses, best, q1, t1 = D.track(view, seeded, q0, t0, im, depth, cfg["tracking"], half)
        out["track"] = dict(t=t, losses=np.array(losses, np.float32), best=best,
                            q0=q0.cpu().numpy(), t0=t0.cpu().numpy(), q1=q1.cpu().numpy(),
                            t1=t1.cpu().numpy())
    if prog.get("densify") is not None:
        pd = prog["densify"]
        if pd["n_before"] != seeded["means3D"].shape[0]:
            raise RuntimeError(f"the recorded densify found {pd['n_before']} gaussians, the "
                               f"seeded map has {seeded['means3D'].shape[0]}")
        im, depth, _ = _frame(ds, pd["t"], dev)
        n_sem = seeded["semantic"].shape[1] if "semantic" in seeded else 0
        added = D.densify(view, seeded, torch.as_tensor(pd["q"], device=dev),
                          torch.as_tensor(pd["tr"], device=dev), im, depth,
                          cfg["mapping"]["sil_thres"], n_sem, _generator(pd["gen_state"]))
        out["densify"] = dict(t=pd["t"], n_added=int(added["means3D"].shape[0]),
                              added={k: x.cpu() for k, x in added.items()})
    del seeded
    if prog.get("map") is not None:
        pm = prog["map"]
        act = pm["v_in"]["active"].cpu()
        m = {k: pm["p_in"][k][act].to(dev) for k in D.LEAVES if k in pm["p_in"]}
        frames = [_frame(ds, int(k), dev) for k in pm["time_idx"]]
        rots, trans = pm["p_in"]["cam_unnorm_rots"][0], pm["p_in"]["cam_trans"][0]
        poses = [(rots[:, int(k)].to(dev), trans[:, int(k)].to(dev)) for k in pm["time_idx"]]
        dec = None if pm["mlp_in"] is None else {k: x.to(dev) for k, x in pm["mlp_in"].items()}
        dec_state = (None, None, 0)
        if pm["mlp_state_in"] is not None:
            mu, nu, count = pm["mlp_state_in"]
            dec_state = ({k: x.to(dev) for k, x in mu.items()},
                         {k: x.to(dev) for k, x in nu.items()}, count)
        if cfg.get("model", {}).get("flag_use_embedding", 0) != 1:
            dec = None
        levels = tuple(ds.num_semantic[:-1]) if "semantic" in m else ()
        _, depth0, _ = frame_arrays(ds, 0)
        radius = float(np.max(depth0)) / cfg["scene_radius_depth_ratio"]
        p2, alive, dec2, losses, first = D.map_phase(view, m, frames, poses, pm["rand_idx"],
                                                     dec, dec_state, cfg["mapping"], levels,
                                                     radius, half)
        rows = torch.nonzero(act)[:, 0][alive.cpu()]
        out["map"] = dict(losses=np.array(losses, np.float32), rows=rows,
                          change={k: float((p2[k][alive] - m[k][alive]).double().norm())
                                  for k in p2},
                          mlp_out=None if dec2 is None else {k: x.cpu() for k, x in dec2.items()},
                          grad_norms=first)
        del m, frames, p2
    return out


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def _leaf_gap(prog: Dict[str, float], ref: Dict[str, float]) -> float:
    """Worst leaf: |prog norm - ref norm| over the larger of the leaf's ref
    norm and the median leaf's."""
    med = float(np.median(list(ref.values())))
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in ref)


def _loss_gap(lp, lr, steps: int) -> float:
    n = min(steps, len(lr))
    if len(lp) < n:
        return float("inf")
    return max(_rel(float(lp[i]), float(lr[i])) for i in range(n))


def numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The compared numbers of the phases both sides observed."""
    out = {}
    if "track" in ref:
        pt, rt = prog["track"], ref["track"]
        out["track_loss_gap"] = _loss_gap(pt["losses"], rt["losses"], LOSS_STEPS["track"])
        out["track_best_gap"] = _rel(pt["best"], rt["best"])
        q0, t0 = rt["q0"].astype(np.float64), rt["t0"].astype(np.float64)
        out["track_change_gap"] = _leaf_gap(
            {"cam_rot": float(np.linalg.norm(pt["q1"] - q0)),
             "cam_trans": float(np.linalg.norm(pt["t1"] - t0))},
            {"cam_rot": float(np.linalg.norm(rt["q1"] - q0)),
             "cam_trans": float(np.linalg.norm(rt["t1"] - t0))})
    if "densify" in ref:
        pd, rd = prog["densify"], ref["densify"]
        out["dens_count_gap"] = _rel(pd["n_added"], rd["n_added"])

        def norms(added):
            return {k: float(x.double().norm()) for k, x in added.items()
                    if k != "unnorm_rotations"}
        out["dens_fields_gap"] = _leaf_gap(norms(pd["added"]), norms(rd["added"]))
    if "map" in ref:
        pm, rm = prog["map"], ref["map"]
        out["map_loss_gap"] = _loss_gap(pm["losses"], rm["losses"], LOSS_STEPS["map"])
        g = rm["grad_norms"]
        med_g = float(np.median(list(g.values())))
        moved = {k for k, x in g.items() if x >= 1e-3 * med_g}
        rows = rm["rows"]

        def change(side, own):
            """The norm of each moved leaf's change over the rows the
            reference keeps; ``own``: the side's own norms (a reference run)."""
            ch = {}
            for k in moved:
                if k.startswith("decoder."):
                    name = k.split(".", 1)[1]
                    ch[k] = float((side["mlp_out"][name].double()
                                   - pm["mlp_in"][name].double()).norm())
                elif own:
                    ch[k] = side["change"][k]
                else:
                    ch[k] = float((side["p_out"][k][rows].double()
                                   - pm["p_in"][k][rows].double()).norm())
            return ch
        out["map_change_gap"] = _leaf_gap(change(pm, "change" in pm), change(rm, True))
    return out


def judge(nums: Dict[str, float], limits: Dict[str, float], expected) -> Dict:
    """Each compared number beside its limit; a number the cell expects and
    the run did not give is a failure (``inf``)."""
    out = {}
    for name in expected:
        v = nums.get(name, float("inf"))
        out[name] = {"value": v, "limit": limits[name]}
    return out


def correct(checked: Dict) -> bool:
    return all(np.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checked.values())


def expected_numbers(limits: Dict, tracks: bool) -> tuple:
    """The numbers a cell compares: those its limits file holds, of the
    phases its traffic runs."""
    return tuple(k for k in NUMBERS if k in limits and (tracks or not k.startswith("track")))


def in_program_place(prog: Dict, other: Dict) -> Dict:
    """The program's observations with what ``other`` (the reference run
    another way: the control, or with a fault planted) gave in their place."""
    out = {}
    for phase, o in other.items():
        out[phase] = dict(prog[phase])
        out[phase].update({k: v for k, v in o.items() if k != "grad_norms"})
    return out
