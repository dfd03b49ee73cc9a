"""Bulk ESS of the slowest-mixing gated variable over all of the window's
draws, over the window's seconds."""


def read(ctx):
    return ctx.ess_min / ctx.window_s
