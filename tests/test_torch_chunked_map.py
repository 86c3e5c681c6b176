"""A map longer than one K2a launch takes: ``sharded_match`` with its
forward search chunked by ``ops/kernels/knn2._chunked`` (the card's path
past ``max_columns`` candidates) and merged by ``merge_top2``. Held here,
in a gloo world of one in this process, at a small cap: the CPU's plain
K2a / K2b sent through ``_chunked`` 256 columns at a time over maps of
1,000 rows (a ragged last chunk of 232), against the exhaustive search of
``test_torch_helpers.exhaustive_sharded_match`` (one plain search over
every row) at every (ratio test, cross-check) setting: every field of
every row equal, on ties across chunk boundaries, a chunk with no valid
row and matches named in the last chunk. Also the counter
``knn2.chunks`` (the launches of a call past one launch; none for a call
of one launch) and the span ``knn2.chunk_merge`` (recorded only while
``torch.profiler`` records).
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
CAP = 256          # columns per launch, in place of max_columns(8)
N_Q, N_DB, WORDS = 64, 1000, 8


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


def _chunked_search(plain, fn):
    """`plain` (``knn2_plain`` / ``knn2_l2_plain``) through the card's
    chunking at CAP columns a launch, each launch counted as the card's
    wrapper counts it."""
    def search(desc1, desc2, valid2):
        def launch(sl):
            profiling.count(f"{fn}.launches")
            return plain(desc1, desc2[sl], valid2[sl])
        return knn2._chunked(launch, desc2.shape[0], CAP, fn)
    return search


def _chunk_map(case, seed=5):
    """64 queries x 1,000 map rows of 8 words, ~10% of the slots invalid,
    with the exact or near partners of one edge of the chunking planted:

    - boundary_ties: queries 0-5 exact at two rows on either side of
      a chunk boundary, a pair each (a tie: the lower row, in the earlier
      chunk, wins), 6-8 exact just after a boundary with a near copy (3
      bits) just before it (a second-best in the other chunk), 12-14 the
      other way round;
    - empty_chunk: chunk 1 (rows 256-511) wholly invalid, half the
      partners planted in it (lost), half in chunk 2;
    - last_chunk: every partner in the ragged last chunk (rows 768-999),
      some twice, so the cross-check searches rows named there.
    """
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 2**32, size=(N_Q, WORDS), dtype=np.uint32)
    db = rng.integers(0, 2**32, size=(N_DB, WORDS), dtype=np.uint32)
    vq = rng.random(N_Q) > 0.1
    vdb = rng.random(N_DB) > 0.1
    bounds = np.arange(CAP, N_DB, CAP)       # first row of chunks 1, 2, 3

    def near(i, bits=3):
        out = q[i].copy()
        for b in rng.choice(32 * WORDS, size=bits, replace=False):
            out[b // 32] ^= np.uint32(1 << (b % 32))
        return out
    if case == "boundary_ties":
        vq[:18] = True
        for k, b in enumerate(bounds):
            db[b - 1] = db[b] = q[2 * k]
            db[b - 2] = db[b + 1] = q[2 * k + 1]
            db[b - 3], db[b + 3] = near(6 + k), q[6 + k]
            db[b - 5], db[b + 5] = q[12 + k], near(12 + k)
            vdb[b - 5:b + 6] = True
    elif case == "empty_chunk":
        vdb[CAP:2 * CAP] = False
        rows = rng.choice(np.arange(CAP, 3 * CAP), size=N_Q, replace=False)
        db[rows] = q
    elif case == "last_chunk":
        rows = rng.choice(np.arange(3 * CAP, N_DB), size=N_Q, replace=False)
        db[rows] = q
        db[rows[:8] - 1] = q[:8]      # a tie inside the chunk
        db[N_DB - 1] = q[N_Q - 1]
        vdb[N_DB - 1] = True
    return tuple(torch.from_numpy(a) for a in
                 (q.view(np.int32), db.view(np.int32), vq, vdb))


@pytest.mark.parametrize("ratio_test,cross_check", worker.FLAGS)
@pytest.mark.parametrize("case", ["boundary_ties", "empty_chunk",
                                  "last_chunk"])
def test_chunked_forward_equals_the_whole_search(mesh, monkeypatch, case,
                                                 ratio_test, cross_check):
    q, db, vq, vdb = _chunk_map(case)
    want = exhaustive_sharded_match(q, db, vq, vdb, 1, ratio_test=ratio_test,
                                    cross_check=cross_check)
    monkeypatch.setattr(knn2, "knn2",
                        _chunked_search(knn2.knn2_plain, "knn2"))
    profiling.reset()
    got = sharded_match(mesh, q, db, vq, vdb, ratio_test=ratio_test,
                        cross_check=cross_check)
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      want[k].numpy(), err_msg=k)
    # 4 launches forward; the 64 named rows take one launch in reverse
    assert profiling.counters()["knn2.chunks"] == 4
    assert profiling.counters()["knn2.launches"] == 4 + int(cross_check)
    if case == "boundary_ties":
        # each tie across a boundary went to the lower row, in the
        # earlier chunk
        bounds = np.arange(CAP, N_DB, CAP)
        np.testing.assert_array_equal(got.idx[0:6:2].numpy(), bounds - 1)
        np.testing.assert_array_equal(got.idx[1:6:2].numpy(), bounds - 2)


@pytest.mark.parametrize("binary", [True, False], ids=["binary", "float"])
@pytest.mark.parametrize("rows,chunks", [(200, 0), (CAP, 0), (2 * CAP, 2),
                                         (N_DB, 4)])
def test_chunks_counter_and_merge_span(mesh, monkeypatch, rows, chunks,
                                       binary):
    """``<fn>.chunks`` counts ceil(rows / CAP) launches a call past one
    launch, and 0 for a call of one launch; the merge span runs once a
    chunked call under the profiler, never for a call of one launch."""
    q, db, vq, vdb = _chunk_map("last_chunk")
    db, vdb = db[:rows], vdb[:rows]
    fn, plain = (("knn2", knn2.knn2_plain) if binary
                 else ("knn2_l2", knn2.knn2_l2_plain))
    if not binary:
        q, db = torch.sin(q[:, :4].float()), torch.sin(db[:, :4].float())
    monkeypatch.setattr(knn2, fn, _chunked_search(plain, fn))
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity
                                            .CPU]):
        sharded_match(mesh, q, db, vq, vdb, binary=binary)
    counts, spans = profiling.counters(), profiling.span_totals()
    assert counts.get(f"{fn}.chunks", 0) == chunks
    assert counts[f"{fn}.launches"] == max(chunks, 1) + 1
    merge = spans.get(f"{fn}.chunk_merge")
    assert (merge["count"] if merge else 0) == (1 if chunks else 0)
    other = "knn2_l2" if binary else "knn2"
    assert f"{other}.chunks" not in counts
    assert f"{other}.chunk_merge" not in spans


def test_merge_span_only_while_the_profiler_records(mesh, monkeypatch):
    """Off the profiler a chunked call opens no span, and its launches
    still count."""
    q, db, vq, vdb = _chunk_map("empty_chunk")
    monkeypatch.setattr(knn2, "knn2",
                        _chunked_search(knn2.knn2_plain, "knn2"))
    profiling.reset()
    sharded_match(mesh, q, db, vq, vdb)
    assert profiling.span_totals() == {}
    assert profiling.counters()["knn2.chunks"] == 4
