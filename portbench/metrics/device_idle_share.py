"""device_idle_share (%, device trace): the share of the window in which
no kernel, copy or memset ran on the card: one less the union of their
intervals over the window."""


def read(ctx):
    if ctx.trace is None or ctx.trace.busy_s <= 0:
        return None
    return 100 * (1 - ctx.trace.busy_s / ctx.trace.window_s)
