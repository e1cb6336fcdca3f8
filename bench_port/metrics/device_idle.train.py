"""Share of the profiled window in which no kernel, copy or memset runs on
the card (the trace's device intervals, merged)."""

from benchlib.readers import idle_share


def read(run):
    return idle_share(run)
