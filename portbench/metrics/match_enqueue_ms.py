"""The host's time to enqueue one query: the host-clock time of the
program's ``knn.sharded_match`` span over its count, in the traced
requests (so under the profiler, which slows the host: compare it only
between runs under the same profiles)."""

from portbench import spans


def read(ctx):
    return spans.span_mean("knn.sharded_match", "host_ms")
