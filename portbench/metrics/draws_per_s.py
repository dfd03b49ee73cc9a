"""Post-warmup draws over all chains in the window, over the window's
seconds (host clock, block end to block end)."""


def read(ctx):
    return ctx.chains * ctx.window_draws / ctx.window_s
