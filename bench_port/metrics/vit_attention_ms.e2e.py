"""Device milliseconds a training step launched under ``vit.attention``: each
ViT block's LayerNorm, q, k, v, scores, softmax, attention dropout, weighted
values and output projection, in the conditioner's forward. From the
program's spans over the profiled epoch (``benchlib.recorded``); None where
they are missing, misaligned or count other steps than the run."""

from benchlib import recorded


def read(run):
    return recorded.step_phase_ms(run, "vit.attention")
