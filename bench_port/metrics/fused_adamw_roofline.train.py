"""The least time of a step's AdamW (f32 parameters read and written, f32
gradients read, both moments read and written, at the HBM peak) over the
device time of the fused_adamw kernels."""

from benchlib.readers import adamw_roofline


def read(run):
    return adamw_roofline(run)
