"""Device milliseconds a request launched under ``serve.descale``: the field's
f32 inverse scaling. From the program's spans over the profiled window
(``benchlib.spans``); None where they are missing or misaligned."""

from benchlib import spans


def read(run):
    return spans.request_device_ms(run, "serve.descale")
