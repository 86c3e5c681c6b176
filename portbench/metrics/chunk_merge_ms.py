"""The merge of a forward search's column chunks per chunked search: the
device time of the program's ``knn2.chunk_merge`` span (CUDA events on the
outputs' stream: the chunks' columns made global and ``merge_top2``) over
its count, in the traced requests. A search that fits one K2a launch has
no such span."""

from portbench import spans


def read(ctx):
    return spans.span_mean("knn2.chunk_merge", "device_ms")
