"""Percent of the card's published peak that the window's model work
fills: the batch's leapfrog steps (each one batched logp+grad) times one
logp+grad's least time by its count (the configuration's FLOPs over the
peak of its precision, or its bytes over the memory rate, whichever is
larger), over the window's seconds."""
from portbench.peaks import least_seconds


def read(ctx):
    steps = float(ctx.tree_size.max(axis=0).sum())
    return 100.0 * steps * least_seconds(ctx.work) / ctx.window_s
