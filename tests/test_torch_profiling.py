"""The port's one registry of spans and counters (``utils/profiling``):
the kernels' launch counts and the host syncs are its counters, and spans
record only while torch.profiler does."""

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from matchinglib_poselib_torch.ops import kernels
from matchinglib_poselib_torch.ops.kernels import fast_nms, knn2
from matchinglib_poselib_torch.utils import profiling
from matchinglib_poselib_torch.utils.profiling import HostSyncs

from test_torch_helpers import textured_image

LAUNCHES = {"fast_nms": "fast_nms.launches", "knn2": "knn2.launches",
            "knn2_l2": "knn2_l2.launches"}


def test_launch_counts_are_views_of_the_registry():
    """K1, K2a and K2b on the CPU run their plain versions and count no
    launch; ``launch_counts`` reads the registry's counters and
    ``reset_launch_counts`` clears them alone."""
    profiling.reset()
    rng = np.random.default_rng(1)
    img = torch.from_numpy(textured_image(rng, 32, 48))[None]
    fast_nms.fast_nms_score(img, 12.0 / 255.0, 3)
    words = torch.from_numpy(rng.integers(-2**31, 2**31, (20, 8),
                                          dtype=np.int64).astype(np.int32))
    valid = torch.ones(20, dtype=torch.bool)
    knn2.knn2(words, words, valid)
    floats = torch.from_numpy(rng.normal(size=(20, 16)).astype(np.float32))
    knn2.knn2_l2(floats, floats, valid)
    assert kernels.launch_counts() == {k: 0 for k in LAUNCHES}
    assert not set(LAUNCHES.values()) & set(profiling.counters())
    for i, name in enumerate(LAUNCHES.values()):
        profiling.count(name, i + 2)
    profiling.count("host_syncs")
    assert kernels.launch_counts() == {"fast_nms": 2, "knn2": 3,
                                       "knn2_l2": 4}
    kernels.reset_launch_counts()
    assert kernels.launch_counts() == {k: 0 for k in LAUNCHES}
    assert profiling.counters() == {"host_syncs": 1}


def test_host_syncs_are_counted_in_the_registry():
    profiling.reset()
    before = HostSyncs.count
    HostSyncs.read(torch.tensor(True), "ransac")
    HostSyncs.fetch(torch.zeros(3))
    assert HostSyncs.count - before == 2
    assert profiling.counters() == {"host_syncs": 2}


def test_spans_sum_under_the_profiler_and_reset_clears_them():
    profiling.reset()
    x = torch.ones(4)
    with profiling.span("outer", x):
        pass
    assert profiling.span_totals() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            with profiling.span("outer", x):
                with profiling.span("inner"):
                    x = x + 1
    totals = profiling.span_totals()
    assert sorted(totals) == ["inner", "outer"]
    for name in ("inner", "outer"):
        assert totals[name]["count"] == 3
        assert totals[name]["device_ms"] is None
    assert totals["outer"]["host_ms"] >= totals["inner"]["host_ms"] > 0
    profiling.count("collectives")
    profiling.reset()
    assert profiling.span_totals() == {} and profiling.counters() == {}
