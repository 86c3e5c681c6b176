"""K2a launches per query of searches longer than one launch takes: the
program's ``knn2.chunks`` counter over every ``sharded_match`` call of the
run. The counter is always on, so the calls are the warm-up's, the
window's and the traced ones (the ``knn.sharded_match`` span's count)."""

from portbench import spans


def read(ctx):
    chunks = spans.counter("knn2.chunks")
    traced = spans.span_count("knn.sharded_match")
    if not chunks or not traced:
        return None
    calls = ctx.driver.params["warm_requests"] + ctx.window.requests + traced
    return chunks / calls
