"""The least time of an E2E training step's GroupNorm-plus-activation work
(every decoder map at the batch: x read and y written once forward, x and dy
read and dx written once backward; the held-out pass's forward maps spread
over the epoch's steps; at the HBM peak) over the device time of the gn_*
kernels."""

from benchlib import e2e_work, peaks
from benchlib.readers import GN_KERNELS, roofline


def read(run):
    if run.trace is None:
        return None
    return roofline(run, e2e_work.gn_bytes(run.config) / peaks.HBM_BYTES, GN_KERNELS)
