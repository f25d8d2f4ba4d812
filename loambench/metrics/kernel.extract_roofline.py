"""kernel.extract_roofline (%): the least time the traced calls' three
extraction kernels could take at HBM bandwidth (``measure.extract_bytes``
from the configuration's shapes, every frame of every call) over their
measured device time."""

from loambench import measure

KERNELS = ("sector_sort", "greedy_nms", "select_points")


def read(ctx):
    s = ctx.trace.device_seconds(*KERNELS)
    if s <= 0:
        return None
    lid, fp = ctx.config["lidar"], ctx.config["features"]
    L, P, S = lid["scan_lines"], lid["points_per_line"], fp["number_sectors"]
    slots = P - (S - 1) * (P // S)
    curv = 8 if fp.get("precise_selection", True) else 4
    rows = ctx.trace.calls * ctx.frames * L
    nbytes = measure.extract_bytes(rows, P, S, slots, fp["max_edge_feats_per_sector"] + 1,
                                   fp["max_planar_feats_per_sector"] + 1, curv)
    return measure.share(nbytes / measure.HBM_BYTES_PER_S, s)
