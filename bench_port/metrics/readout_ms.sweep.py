"""Device milliseconds a request launched under ``decoder.readout`` (the
readout's product, GroupNorm, tanh). From the program's spans over the
profiled window (``benchlib.spans``); None where they are missing or
misaligned."""

from benchlib import spans


def read(run):
    return spans.request_device_ms(run, "decoder.readout")
