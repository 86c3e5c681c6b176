"""K2a's share of its roofline, counted at the least work of exact 2-NN
with the cross-check: the forward search of a query's rows against every
map row, and the reverse search of at most as many rows, those the
forward matches name (``rooflines/k2a.py``, from the run's configuration),
over K2a's device time per request, summed over all its launches in the
traced requests (torch.profiler)."""


def least_s(config: dict, k2a) -> float:
    """K2a's least time per query of the map configuration `config`."""
    n1 = config["slots"]
    bits = 32 * config["words"]
    bound = k2a.bound_s(n1, config["frames"] * n1, bits)
    if config["cross_check"]:
        bound += k2a.bound_s(n1, n1, bits)
    return bound


def read(ctx):
    k2a = ctx.roofline("k2a")
    trace = ctx.trace
    config = getattr(ctx.driver, "config", None)
    if not trace or not config:
        return None
    device_s = sum(s for name, (s, _) in trace["ops"].items()
                   if k2a.KERNEL.search(name))
    if device_s <= 0:
        return None
    return 100.0 * least_s(config, k2a) * trace["requests"] / device_s
