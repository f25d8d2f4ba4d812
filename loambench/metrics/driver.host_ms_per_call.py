"""driver.host_ms_per_call (ms): the host's time from a call's entry to its
return, no sync inside, averaged over the window's calls (the benchmark's
own clock). What the host spends issuing a call; it moves call_p95_ms."""


def read(ctx):
    return 1e3 * sum(ctx.host_s) / len(ctx.host_s) if ctx.host_s else None
