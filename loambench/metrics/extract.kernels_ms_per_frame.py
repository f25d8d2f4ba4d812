"""extract.kernels_ms_per_frame (ms): device time of the extraction's three
kernels (the sector sort, the greedy pick, the copy-out) in the traced
calls, a frame."""

KERNELS = ("sector_sort", "greedy_nms", "select_points")


def read(ctx):
    s = ctx.trace.device_seconds(*KERNELS)
    return 1e3 * s / (ctx.trace.calls * ctx.frames) if s > 0 else None
