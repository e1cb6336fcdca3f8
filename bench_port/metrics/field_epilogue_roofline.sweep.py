"""The least time of a request's field epilogue (each decoded element read
once in the configuration's dtype and written once in f32, at the HBM peak)
over the device time of the field_epilogue kernels; None where none ran."""

from benchlib import peaks
from benchlib.readers import roofline

INPUT_BYTES = {"bfloat16": 2, "float32": 4}


def read(run):
    if run.trace is None:
        return None
    cfg = run.config
    per_field = cfg["num_time"] * cfg["num_node"] * (INPUT_BYTES[cfg["dtype"]] + 4)
    return roofline(run, per_field / peaks.HBM_BYTES, ("field_epilogue",))
