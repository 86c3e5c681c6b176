"""``sharded_match``'s merge per query: the device time of the program's
``knn.merge`` span (CUDA events on the query's stream: from the merge's
first op to its last, the all-gathers and the device waiting on the
merge's launches included) over its count, in the traced requests."""

from portbench import spans


def read(ctx):
    return spans.span_mean("knn.merge", "device_ms")
