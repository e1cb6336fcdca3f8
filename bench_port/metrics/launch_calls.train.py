"""Kernel- and graph-launch calls into the CUDA runtime and driver per train
step, from the profiler's host-side API records."""

from benchlib.readers import launches_per_unit


def read(run):
    return launches_per_unit(run)
