"""map.keyframes_per_frame (count): keyframes a frame in the traced calls,
by the scan-to-map rule applied to the returned trajectory (the first frame
counts): how often the traffic makes the map insert and the prep-cache
rebuild run."""

from loambench.reference import pipelines


def read(ctx):
    cfg = ctx.config.get("scan_to_map")
    if cfg is None:
        return None
    n = sum(pipelines.keyframe_count((x["q"].cpu(), x["t"].cpu()), cfg) for x in ctx.traced)
    return n / (len(ctx.traced) * ctx.frames)
