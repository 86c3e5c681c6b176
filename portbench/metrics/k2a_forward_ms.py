"""K2a's forward search per query (2,048 queries against the map): the
device time of the program's ``knn.forward`` span (CUDA events on the
query's stream) over its count, in the traced requests."""

from portbench import spans


def read(ctx):
    return spans.span_mean("knn.forward", "device_ms")
