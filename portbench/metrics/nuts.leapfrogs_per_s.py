"""Leapfrog steps of the batch per second: the sum over the window's draws
of the largest tree_size over the lanes (all lanes step together under
masks), over the window's seconds."""


def read(ctx):
    return float(ctx.tree_size.max(axis=0).sum()) / ctx.window_s
