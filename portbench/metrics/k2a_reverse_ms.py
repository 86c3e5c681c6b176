"""K2a's reverse search per query (every map row against the 2,048
queries, for the cross-check): the device time of the program's
``knn.reverse`` span (CUDA events on the query's stream) over its count,
in the traced requests."""

from portbench import spans


def read(ctx):
    return spans.span_mean("knn.reverse", "device_ms")
