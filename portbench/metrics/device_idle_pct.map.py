"""The device's idle share of the traced requests: 100 minus the union of
its busy intervals (kernels, copies, sets; torch.profiler) over their
host-clock length."""


def read(ctx):
    trace = ctx.trace
    if not trace or trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
