"""Bytes the collectives leave on this rank per query, in MB: the
program's ``collective_bytes`` counter over every ``sharded_match`` call of
the run. The counter is always on, so the calls are the warm-up's, the
window's and the traced ones (the ``knn.sharded_match`` span's count)."""

from portbench import spans


def read(ctx):
    total = spans.counter("collective_bytes")
    traced = spans.span_count("knn.sharded_match")
    if not total or not traced:
        return None
    calls = ctx.driver.params["warm_requests"] + ctx.window.requests + traced
    return total / 1e6 / calls
