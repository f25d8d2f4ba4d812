"""mesh.collective_ms_per_frame (ms): device time of the mesh's collective
kernel (``peer_gather.cu``'s gather and sum) in this rank's traced calls, a
frame; the run reports the slowest rank's."""


def read(ctx):
    s = ctx.trace.device_seconds("peer_kernel")
    return 1e3 * s / (ctx.trace.calls * ctx.frames) if s > 0 else None
