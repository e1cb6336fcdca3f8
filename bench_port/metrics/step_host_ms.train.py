"""Mean host milliseconds of a ``train.step`` span: the host's dispatch time
for a step. From the program's spans over the profiled window
(``benchlib.spans``); None where they are missing or misaligned."""

from benchlib import spans


def read(run):
    return spans.step_host_ms(run)
