"""Percent of the traced span of the window in which no operation ran on
the card: one minus the union of the device's operations in the
profiler's trace over the span's length. Nothing where the trace holds
no device operation (no trace, or no card)."""
from portbench import devtrace


def read(ctx):
    if ctx.events is None or ctx.events["window"] is None \
            or not ctx.events["device"]:
        return None
    lo, hi = ctx.events["window"]
    busy = sum(b - a for a, b in devtrace.busy_intervals(
        ctx.events["device"], ctx.events["window"]))
    return 100.0 * (1.0 - busy / (hi - lo))
