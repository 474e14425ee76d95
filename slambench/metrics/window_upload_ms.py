"""The mapping window's staging time: the mean, over the traced period's
mapping frames, of the program's ``hs.window`` span
(``SLAMRunner._window_arrays``: the window's frames stacked on the host and
copied to the device)."""
from slambench import spans


def read(record):
    return spans.ms_per_frame(record, "hs.window")
