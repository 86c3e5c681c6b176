"""K2a's share of its roofline: a query's least time for the cross-checked
exact 2-NN (``rooflines/k2a.least_s``, from the run's configuration) over
the device's busy time per traced query (torch.profiler: the union of
every kernel, copy and set), whatever kernels run the search. The same
quantity as ``k2a_roofline.kitti11``, under the name of its own cell."""


def read(ctx):
    trace = ctx.trace
    config = getattr(ctx.driver, "config", None)
    if not trace or not config or trace["busy_s"] <= 0:
        return None
    least = ctx.roofline("k2a").least_s(config)
    return 100.0 * least * trace["requests"] / trace["busy_s"]
