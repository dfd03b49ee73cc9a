"""Set-up seconds: from the process's start to the first block end at or
after the last tuning draw (import, model build, kernel libraries, the
NUTS initialization and the tuning)."""


def read(ctx):
    return ctx.setup_s
