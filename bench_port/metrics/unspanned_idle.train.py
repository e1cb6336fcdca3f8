"""Share of the window's idle time under no phase span of a step (no span, or
the self time of ``train.epoch`` or ``train.step``). From the program's
spans over the profiled window (``benchlib.spans``); None where they are
missing or misaligned."""

from benchlib import spans


def read(run):
    return spans.unspanned_idle(run)
