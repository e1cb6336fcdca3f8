"""The least time of a decode's GroupNorm-plus-activation work (every map's
x read and y written once, at the HBM peak) over the device time of the
gn_* kernels."""

from benchlib.readers import gn_roofline


def read(run):
    return gn_roofline(run, train=False)
