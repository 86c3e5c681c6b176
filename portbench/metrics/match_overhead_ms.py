"""What a query costs beyond K2a: the window's wall ms per query (host
clock, all queries) minus K2a's device ms per query (torch.profiler, the
traced queries): the merges, the all-gathers, the launches and the host
read of ``sharded_match``."""


def read(ctx):
    k2a = ctx.roofline("k2a")
    trace = ctx.trace
    if not trace or not ctx.window.units:
        return None
    device_s = sum(s for name, (s, _) in trace["ops"].items()
                   if k2a.KERNEL.search(name))
    if device_s <= 0:
        return None
    wall = ctx.window.seconds / ctx.window.units
    return 1e3 * (wall - device_s / trace["requests"])
