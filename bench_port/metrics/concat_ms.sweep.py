"""Device milliseconds a request launched under ``serve.concat``: the tail
chunk's padding and the chunks' concatenation. From the program's spans over
the profiled window (``benchlib.spans``); None where they are missing or
misaligned."""

from benchlib import spans


def read(run):
    return spans.request_device_ms(run, "serve.concat")
