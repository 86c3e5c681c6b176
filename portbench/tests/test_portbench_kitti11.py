"""The cell ``orbmap.kitti11``: the 11 KITTI odometry training drives as
one map, past one K2a launch's columns, so that each forward search is
chunked and merged. Its files and entries are found by name; its map
takes 3 launches; small copies run on the CPU and come out correct (once
through the card's chunking at a small cap); its new metric readers
reckon K2a's least work and read the program's chunk span and counter,
or nothing where the program has none. The ``gpu`` case runs the chunked
forward on the card past 2^24 columns."""

import json
import math
import re
import types

import pytest
import torch

from conftest import ROOT
from portbench import harness, spans, tracing

from matchinglib_poselib_torch.ops.kernels import knn2
from matchinglib_poselib_torch.utils import profiling

CELL = "orbmap.kitti11"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NEW = ("k2a_roofline.kitti11", "chunk_merge_ms", "k2a_chunks_per_query")
MAP_METRICS = ("match_overhead_ms", "device_idle_pct.map", "k2a_forward_ms",
               "k2a_reverse_ms", "merge_ms", "match_enqueue_ms",
               "collective_mb")
# K2a's device names today (the fixed widths and the runtime width), not
# K2b's knn2_l2_kernel: the gpu case counts its launches in a trace
K2A_KERNEL = re.compile(r"\bknn2(?:_wide)?_kernel\b")
# the cell at a size a test run holds, on the CPU: one keyframe a drive
SMALL = {"config": {"frames": 11, "slots": 64, "least_valid_slots": 48},
         "params": {"pool_per_second": 2000, "check_queries": 4,
                    "traced_requests": 2, "flip_block_rows": 128}}


def _reader(name):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py")


def test_cell_files_and_entries_found_by_name():
    cell = harness.find_cell(CELL, BENCH)
    assert cell.entry["config"] == "kitti11_orb_map"
    assert cell.entry["chips"] == 1 and cell.spec["generator"] == "map_queries"
    conf = next(c for c in BENCH["configs"] if c["name"] == "kitti11_orb_map")
    assert conf["file"] == "portbench/configs/kitti11_orb_map.json"
    assert conf["reduced"] == [] and cell.config["reduced"] == []
    assert cell.config["source"] == conf["source"]
    assert cell.spec["limits"] == {"rows_differing": 0}
    e2e, layer = harness.cell_metrics(BENCH, CELL)
    assert {m["name"] for m in e2e} == {"queries_per_s", "setup_s"}
    assert {m["name"] for m in layer} == set(NEW) | set(MAP_METRICS)
    # the same share as orbmap.seq00's k2a_roofline, under a name of its own
    assert "k2a_roofline" not in {m["name"] for m in layer}
    for name in NEW:
        assert (harness.HERE / "metrics" / f"{name}.py").is_file()


def test_map_rows_are_the_drives_and_take_three_launches():
    config = harness.find_cell(CELL, BENCH).config
    frames = config["sequence_frames"]
    assert list(frames) == [f"{s:02d}" for s in range(11)]
    assert sum(frames.values()) == config["frames"] == 23201
    rows = config["frames"] * config["slots"]
    assert rows == 47_515_648
    cap = knn2.max_columns(knn2.kernel_words(config["words"]))
    assert cap == 1 << 24 and math.ceil(rows / cap) == 3
    assert rows - 2 * cap == 13_961_216
    # 1.52 GB of words on the card
    assert round(rows * 4 * config["words"] / 1e9, 2) == 1.52


def _chunked_plain(cap):
    """The CPU's plain K2a through the card's chunking at `cap` columns a
    launch, counted as the card's wrapper counts it."""
    def search(desc1, desc2, valid2):
        def launch(sl):
            profiling.count("knn2.launches")
            return knn2.knn2_plain(desc1, desc2[sl], valid2[sl])
        return knn2._chunked(launch, desc2.shape[0], cap, "knn2")
    return search


@pytest.mark.parametrize("chunked", [False, True],
                         ids=["plain", "chunked_at_256"])
def test_small_copy_on_the_cpu_is_correct(monkeypatch, chunked):
    """A traced small run is correct. Its K2a roofline and chunk span have
    nothing to read on the CPU (no kernel, no device clock); its chunk
    counter reads 3 a query where the search is chunked (704 rows at 256
    columns a launch) and nothing where the CPU searches in one."""
    if chunked:
        monkeypatch.setattr(knn2, "knn2", _chunked_plain(256))
    profiling.reset()
    out = harness.run_cell(CELL, 2**31 + 24, 0.2, True, torch.device("cpu"),
                           overrides=SMALL)
    assert out["correct"] and out["failed"] == 0
    assert out["checks"]["rows_differing"]["value"] == 0
    metrics = out["metrics"]
    assert "k2a_roofline.kitti11" not in metrics
    assert "chunk_merge_ms" not in metrics
    if chunked:
        assert metrics["k2a_chunks_per_query"] == {"value": 3.0,
                                                   "unit": "chunks/query"}
        assert profiling.span_totals()["knn2.chunk_merge"]["count"] > 0
    else:
        assert "k2a_chunks_per_query" not in metrics
    assert metrics["collective_mb"]["value"] > 0


def _stub(config, ops, requests=16):
    """A run's context around a trace of `ops` {name: (seconds, count)},
    the device busy for their summed seconds."""
    busy_s = sum(s for s, _ in ops.values())
    return types.SimpleNamespace(
        driver=types.SimpleNamespace(config=config, params={
            "warm_requests": 2}),
        trace={"ops": ops, "requests": requests, "busy_s": busy_s},
        window=types.SimpleNamespace(requests=100),
        roofline=lambda kernel: harness.load_module(
            harness.HERE / "rooflines" / f"{kernel}.py"))


def test_k2a_roofline_counts_the_least_work_of_a_query():
    """4.769 ms a query at full size: the forward 2048 x 47,515,648 and
    the reverse 2048 x 2048 at 256 bits, at the b1 tensor-core rate; read
    against the device's busy time per traced query, every op in it."""
    config = harness.find_cell(CELL, BENCH).config
    k2a = harness.load_module(harness.HERE / "rooflines" / "k2a.py")
    assert round(k2a.least_s(config) * 1e3, 3) == 4.769
    no_cross = dict(config, cross_check=False)
    assert k2a.least_s(config) - k2a.least_s(no_cross) == (
        pytest.approx(k2a.bound_s(2048, 2048, 256)))
    ops = {"void knn2_kernel<8, 0>(unsigned int const*)": (0.6, 48),
           "void knn2_kernel<8, 2>(unsigned int const*)": (0.2, 16),
           "void at::native::radixSortKVInPlace(float*)": (0.0016, 16)}
    value = _reader("k2a_roofline.kitti11").read(_stub(config, ops))
    assert value * 0.8016 / (100 * 16) == pytest.approx(k2a.least_s(config),
                                                       rel=1e-12)


def test_new_readers_read_nothing_without_the_programs_span_or_counter(
        monkeypatch):
    """As on a program that has no chunk span or counter (or no registry
    at all), and with no trace or a trace in which the device did
    nothing, each reader returns None and does not raise."""
    config = harness.find_cell(CELL, BENCH).config
    profiling.reset()
    profiling.count("collective_bytes", 8)
    ctx = _stub(config, {})
    for name in NEW:
        assert _reader(name).read(ctx) is None
    ctx.trace = None
    assert _reader("k2a_roofline.kitti11").read(ctx) is None
    monkeypatch.setattr(spans, "_profiling", lambda: types.ModuleType("old"))
    for name in ("chunk_merge_ms", "k2a_chunks_per_query"):
        assert _reader(name).read(ctx) is None


@pytest.mark.gpu
def test_chunked_forward_on_the_card(card):
    """On the card, at 2048 x (2^24 + 2^20) rows (8,704 keyframes): every
    field of every checked query equal to ``reference/hamming.py``;
    ``knn2.chunks`` counts the forward's 2 launches and ``knn2.launches``
    one more; the profiler counts as many K2a kernels per traced query as
    the registry counts launches."""
    chunks = 2
    cell = harness.find_cell(CELL, BENCH)
    config = dict(cell.config, frames=((1 << 24) + (1 << 20)) // 2048)
    params = cell.spec["params"]
    driver = cell.generator.Driver(config, params, 2**31 + 2400, card, 1.0)
    try:
        driver.warm()
        first = params["warm_requests"]
        profiling.reset()
        for i in range(first, first + 10):
            driver.request(i)
        counts = profiling.counters()
        assert counts["knn2.chunks"] == 10 * chunks
        assert counts["knn2.launches"] == 10 * (chunks + 1)
        before = profiling.counters()["knn2.launches"]
        summary = tracing.trace_requests(driver, 2, card, first + 10)
        launched = profiling.counters()["knn2.launches"] - before
        kernels = sum(c for name, (_, c) in summary["ops"].items()
                      if K2A_KERNEL.search(name))
        # two profiles of 2 queries each, the first one's ops counted
        assert launched == 4 * (chunks + 1)
        assert kernels == launched // 2, summary["ops"]
        merge = profiling.span_totals()["knn2.chunk_merge"]
        assert merge["count"] >= 2 and merge["device_ms"] > 0
        driver.free_program()
        checks = driver.check(cell.spec["limits"])
        assert checks["rows_differing"]["value"] == 0
    finally:
        driver.close()
