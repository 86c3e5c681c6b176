"""What a query costs beyond the device's work: the window's wall ms per
query (host clock, all queries) minus the device's busy ms per query
(torch.profiler, the traced queries: the union of every kernel, copy and
set): the host's read of the matches, the launches and the Python between
queries of ``sharded_match``, while the card waits."""


def read(ctx):
    trace = ctx.trace
    if not trace or not ctx.window.units or trace["busy_s"] <= 0:
        return None
    wall = ctx.window.seconds / ctx.window.units
    return 1e3 * (wall - trace["busy_s"] / trace["requests"])
