"""The mapping phase's binning time: the program's ``hs.map.bin`` spans (each
``bin_window`` call: one stream binning a window frame) summed a mapping
frame, averaged over the traced period's mapping frames."""
from slambench import spans


def read(record):
    return spans.ms_per_frame(record, "hs.map.bin")
