"""driver.graph_launches_per_call (count): the host's launch calls (kernels
and CUDA graphs) inside the program's ``driver_loop`` ranges of the traced
calls, a call. One where a call is one graph; a frame-by-frame driver
launches one a frame."""

from loambench import trace


def read(ctx):
    n = ctx.trace.launches(trace.DRIVER)
    return n / ctx.trace.calls if n else None
