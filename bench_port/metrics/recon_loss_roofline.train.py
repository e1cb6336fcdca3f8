"""The least time of a train step's reconstruction loss pair (the decoded
field and its target read once forward, both read again and the field's
gradient written once backward: 5 x the configuration's item size an
element, at the HBM peak) over the device time of the recon_loss_pair
kernels; None where none ran."""

from benchlib import peaks
from benchlib.readers import roofline

ITEM_BYTES = {"bfloat16": 2, "float32": 4}


def read(run):
    if run.trace is None:
        return None
    cfg = run.config
    per_step = (run.facts["batch"] * cfg["num_time"] * cfg["num_node"]
                * ITEM_BYTES[cfg["dtype"]] * 5)
    return roofline(run, per_step / peaks.HBM_BYTES, ("recon_loss_pair",))
