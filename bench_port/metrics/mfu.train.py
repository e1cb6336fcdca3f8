"""The frozen model FLOPs of the work done in the untraced window over its
length, as a share of the card's dense bf16 peak."""

from benchlib.readers import mfu


def read(run):
    return mfu(run)
