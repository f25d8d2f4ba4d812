"""device.idle_share (%): the share of the traced window in which the card
ran nothing: 1 - (the union of its kernels', copies' and fills' intervals)
/ (the window). A union, because a graph's branches run at once."""


def read(ctx):
    w = ctx.trace.window.end - ctx.trace.window.start
    return 100.0 * (1.0 - ctx.trace.busy() / w) if w > 0 else None
