"""Percent of the batch's leapfrog steps that some lane needed: the sum over
the window's draws of the mean tree_size over the lanes, over the sum of
the largest."""


def read(ctx):
    return 100.0 * float(ctx.tree_size.mean(axis=0).sum()) / float(
        ctx.tree_size.max(axis=0).sum())
