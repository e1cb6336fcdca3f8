"""Device milliseconds a training step launched under ``lc.conditioner``: the
conditioner's call in the loss (the power iteration and the CNN's forward).
From the program's spans over the profiled epoch (``benchlib.recorded``);
None where they are missing, misaligned or count other steps than the run."""

from benchlib import recorded


def read(run):
    return recorded.step_phase_ms(run, "lc.conditioner")
