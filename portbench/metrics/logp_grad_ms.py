"""Milliseconds of one batched logp+grad of the model, at the cell's
chains and at the window's last draws: host clock around a fixed number of
calls between two synchronisations, after the window."""


def read(ctx):
    return ctx.logp_grad_ms
