"""K2a's share of its roofline: the least time of the cell's K2a calls per
request (``rooflines/k2a.py``) over K2a's device time per request, summed
over its launches in the traced requests (torch.profiler)."""


def read(ctx):
    k2a = ctx.roofline("k2a")
    trace = ctx.trace
    calls = getattr(ctx.driver, "k2a_calls", None)
    if not trace or not calls:
        return None
    device_s = sum(s for name, (s, _) in trace["ops"].items()
                   if k2a.KERNEL.search(name))
    if device_s <= 0:
        return None
    bound = sum(k2a.bound_s(*c) for c in calls)
    return 100.0 * bound * trace["requests"] / device_s
