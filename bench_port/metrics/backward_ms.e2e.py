"""Device milliseconds a training step launched under ``lc.backward``:
autograd's backward through the decoder's data gradient and the CNN, and the
gradients read out. From the program's spans over the profiled epoch
(``benchlib.recorded``); None where they are missing, misaligned or count
other steps than the run."""

from benchlib import recorded


def read(run):
    return recorded.step_phase_ms(run, "lc.backward")
