"""icf.iterations_per_pair (count): outer ICF iterations the traced calls'
registrations solved (their details' ``num_iterations``), a registered pair
(scan-to-scan) or frame (scan-to-map)."""


def read(ctx):
    its = [int(x["iterations"].sum()) for x in ctx.traced]
    n = sum(int(x["iterations"].numel()) for x in ctx.traced)
    return sum(its) / n if n else None
