"""The program's spans and counters reach the result line: a traced run on
the CPU reports the host-clock span and the collective bytes, and leaves
out the device-clock spans, which need a card."""

import pytest
import torch

from conftest import SMALL
from portbench import harness

from matchinglib_poselib_torch.utils import profiling

DEVICE_CLOCK = ("k2a_forward_ms", "k2a_reverse_ms", "merge_ms")


def test_traced_cpu_run_reports_the_program_spans():
    small = SMALL["orbmap.seq00"]
    profiling.reset()
    out = harness.run_cell("orbmap.seq00", 2**31 + 11, 0.2, True,
                           torch.device("cpu"), overrides=small)
    assert out["correct"]
    metrics = out["metrics"]
    assert metrics["match_enqueue_ms"]["value"] > 0
    assert metrics["match_enqueue_ms"]["unit"] == "ms"
    # per query: the (1, 3, N1) candidates and the (1, N1) reverse answers
    # of the rows the matches name, int32 each
    n1 = small["config"]["slots"]
    assert metrics["collective_mb"]["value"] == pytest.approx(
        4 * (3 * n1 + n1) / 1e6, rel=1e-12)
    assert metrics["collective_mb"]["unit"] == "MB/query"
    assert not set(DEVICE_CLOCK) & set(metrics)
    for name in ("knn.sharded_match", "knn.forward", "knn.reverse",
                 "knn.merge"):
        assert profiling.span_totals()[name]["device_ms"] is None


def test_untraced_run_records_no_span():
    """Off the profiler no span records, and the counters still count: two
    all-gathers for every query of the warm-up and of the window."""
    profiling.reset()
    out = harness.run_cell("orbmap.seq00", 2**31 + 12, 0.2, False,
                           torch.device("cpu"),
                           overrides=SMALL["orbmap.seq00"])
    assert out["correct"]
    assert profiling.span_totals() == {}
    warm = harness.find_cell("orbmap.seq00").spec["params"]["warm_requests"]
    assert profiling.counters()["collectives"] == 2 * (warm
                                                       + out["attempted"])
