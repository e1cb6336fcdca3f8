"""Device idle milliseconds a step under ``train.forward``: the encoder's and
decoder's forward and the loss. From the program's spans over the profiled
window (``benchlib.spans``); None where they are missing or misaligned."""

from benchlib import spans


def read(run):
    return spans.phase_idle_ms(run, "train.forward")
