"""Device milliseconds a training step launched under ``lc.decode``: the
latents' descale and the frozen decoder's forward, its readout inside. From
the program's spans over the profiled epoch (``benchlib.recorded``); None
where they are missing, misaligned or count other steps than the run."""

from benchlib import recorded


def read(run):
    return recorded.step_phase_ms(run, "lc.decode")
