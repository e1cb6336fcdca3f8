"""Device idle milliseconds a step under ``train.backward``: autograd's
backward and the gradients read out. From the program's spans over the
profiled window (``benchlib.spans``); None where they are missing or
misaligned."""

from benchlib import spans


def read(run):
    return spans.phase_idle_ms(run, "train.backward")
