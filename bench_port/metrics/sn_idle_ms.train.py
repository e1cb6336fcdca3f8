"""Device idle milliseconds a step under ``train.sn``: the power iteration and
sigma's rank-1 terms. From the program's spans over the profiled window
(``benchlib.spans``); None where they are missing or misaligned."""

from benchlib import spans


def read(run):
    return spans.phase_idle_ms(run, "train.sn")
