"""The slowest gated variable's bulk ESS over the window's draws: ess_per_s
over draws_per_s of the same window."""


def read(ctx):
    return ctx.ess_min / (ctx.chains * ctx.window_draws)
