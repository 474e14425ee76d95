"""The tracker's spans in the traced period: ``hs.track.cache`` (a pose
cache built) and ``hs.track.iter`` (one tracking iteration, render to Adam
step), which ``hierslam_torch``'s tracker records inside ``hs.track`` on
the thread that runs ``step`` (``slam/tracking.py``).  Every frame of a
full-SLAM period tracks, the mapping frame too."""
from __future__ import annotations

from typing import Dict, List

from slambench import spans


def per_frame(tr: Dict, name: str) -> List[List[Dict]]:
    """For each frame of the period, its spans named ``name``."""
    kinds = dict.fromkeys(f["kind"] for f in tr["frames"])
    return [s for kind in kinds for s in spans.in_frames(tr, name, kind)]


def iters(tr: Dict) -> List[Dict]:
    """The ``hs.track.iter`` spans of the period."""
    return [s for frame in per_frame(tr, "hs.track.iter") for s in frame]
