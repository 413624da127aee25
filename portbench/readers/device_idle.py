"""The share of the window in which no operation ran on the device."""


def read(ctx, spec):
    tr = ctx.trace
    if not len(tr.dev):
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
