"""The densify's host time: the mean, over the traced period's mapping
frames, of the program's ``hs.densify`` span (``SLAMRunner._densify``: the
non-presence render, the draws, the insertion and the overflow remedies)."""
from slambench import spans


def read(record):
    return spans.ms_per_frame(record, "hs.densify")
