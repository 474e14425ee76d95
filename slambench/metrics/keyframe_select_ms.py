"""Keyframe selection's host time: the mean, over the traced period's
mapping frames, of the program's ``hs.keyframes`` span (the estimated
pose read back and ``slam/keyframes.py::keyframe_selection_overlap``)."""
from slambench import spans


def read(record):
    return spans.ms_per_frame(record, "hs.keyframes")
