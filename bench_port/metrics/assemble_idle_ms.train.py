"""Device idle milliseconds a step under ``train.assemble``: host draws, pinned
copies, gather_augment. From the program's spans over the profiled window
(``benchlib.spans``); None where they are missing or misaligned."""

from benchlib import spans


def read(run):
    return spans.phase_idle_ms(run, "train.assemble")
