"""``parallel.matching.sharded_match``'s cross-check searches in reverse
only the rows its merged matches name; held here, in a gloo world of one
in this process, to the exhaustive reverse over every map row
(``test_torch_helpers.exhaustive_sharded_match``) on the edge cases of
the named rows, binary (plain K2a) and float (plain K2b), at every
(ratio test, cross-check) setting: every field of every row equal. The
worlds of 4 hold the same on reverse_case's inputs
(tests/test_torch_parallel.py). Also: one kernel call more with the
cross-check than without (knn2.launches / knn2_l2.launches, the CPU's
plain versions wrapped to count as the card's wrappers do), its one
all-gather of N1 ints, and the counter ``knn.reverse_rows``.
"""

import datetime

import numpy as np
import pytest
import torch
import torch.distributed as dist

from matchinglib_poselib_torch.ops.kernels import knn2
from matchinglib_poselib_torch.parallel import mesh as pmesh
from matchinglib_poselib_torch.parallel.matching import sharded_match
from matchinglib_poselib_torch.utils import profiling

import torch_parallel_worker as worker
from test_torch_helpers import exhaustive_sharded_match

FIELDS = ("idx", "distance", "second_distance", "mask")


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    store = str(tmp_path_factory.mktemp("world") / "store")
    dist.init_process_group("gloo", store=dist.FileStore(store, 1), rank=0,
                            world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        yield pmesh.make_mesh(1, device="cpu")
    finally:
        dist.destroy_process_group()


def _edge(name, binary):
    """reverse_case's inputs changed to one edge of the named rows."""
    q, db, vq, vdb = (torch.as_tensor(a) for a in
                      worker.reverse_case(binary, 4))
    n1 = q.shape[0]
    if name == "map_invalid":
        vdb[:] = False
    elif name == "queries_invalid":
        vq[:] = False
    elif name == "one_row":
        db, vdb = q[3:4].clone(), torch.ones(1, dtype=torch.bool)
    elif name == "fewer_rows_than_queries":
        # every map row named by several queries, a quarter of them exact
        db, vdb = db[:n1 // 4].clone(), vdb[:n1 // 4].clone()
        db[::2] = q[:n1 // 8]
    elif name == "one_query_repeated":
        q[:] = q[5]
    return q, db, vq, vdb


@pytest.mark.parametrize("binary", [True, False], ids=["binary", "float"])
@pytest.mark.parametrize("name", ["map_invalid", "queries_invalid",
                                  "one_row", "fewer_rows_than_queries",
                                  "one_query_repeated"])
def test_named_row_reverse_on_edge_cases(mesh, name, binary):
    q, db, vq, vdb = _edge(name, binary)
    for ratio_test, cross_check in worker.FLAGS:
        got = sharded_match(mesh, q, db, vq, vdb, binary=binary,
                            ratio_test=ratio_test, cross_check=cross_check)
        want = exhaustive_sharded_match(q, db, vq, vdb, 1, binary=binary,
                                        ratio_test=ratio_test,
                                        cross_check=cross_check)
        for k in FIELDS:
            np.testing.assert_array_equal(
                getattr(got, k).numpy(), want[k].numpy(),
                err_msg=f"{name} {ratio_test} {cross_check}: {k}")


def _counting(fn, name):
    """`fn`, counted as one launch of `name` a call, as the card's wrapper
    counts a search of at most ``max_columns`` candidates."""
    def call(*a, **k):
        profiling.count(f"{name}.launches")
        return fn(*a, **k)
    return call


@pytest.mark.parametrize("cross_check", [True, False])
@pytest.mark.parametrize("binary", [True, False], ids=["binary", "float"])
def test_kernel_calls_collectives_and_reverse_rows(mesh, monkeypatch,
                                                   binary, cross_check):
    """Two kernel calls and two all-gathers a call with the cross-check
    (the second all-gather N1 int32), one and one without; the counter
    ``knn.reverse_rows`` reads N1 and 0. The kernel not used stays at 0."""
    for name in ("knn2", "knn2_l2"):
        monkeypatch.setattr(knn2, name, _counting(getattr(knn2, name), name))
    q, db, vq, vdb = (torch.as_tensor(a) for a in
                      worker.reverse_case(binary, 4))
    n1 = q.shape[0]
    profiling.reset()
    sharded_match(mesh, q, db, vq, vdb, binary=binary,
                  cross_check=cross_check)
    c = int(cross_check)
    used, other = ("knn2", "knn2_l2") if binary else ("knn2_l2", "knn2")
    counts = profiling.counters()
    assert counts[f"{used}.launches"] == 1 + c
    assert f"{other}.launches" not in counts
    assert counts["collectives"] == 1 + c
    assert counts["collective_bytes"] == 4 * (3 + c) * n1
    assert counts["knn.reverse_rows"] == c * n1
