"""K2a's roofline count and the readers that set it against the device's
time: the least time of a cross-checked exact 2-NN query from the map's
configuration, at the b1 tensor-core rate, over the device's busy time per
traced query, whatever kernels run the search."""

import types

import pytest

from portbench import harness

K2A = harness.load_module(harness.HERE / "rooflines" / "k2a.py")
# K2a's share in each map cell, and the query's time beyond the device's
SHARES = ("k2a_roofline", "k2a_roofline.kitti11")
BUSY_READERS = SHARES + ("match_overhead_ms",)
# one query's search as today's kernel runs it, renamed, or split into a
# sweep and a merge: the same busy time per traced query
LAYOUTS = {
    "knn2": {"void knn2_kernel<8, 0>(unsigned int const*)": (0.8, 16)},
    "renamed": {"void hamming_top2_kernel<8>(unsigned int const*)":
                (0.8, 16)},
    "split": {"void hamming_sweep_kernel(unsigned int const*)": (0.7, 48),
              "void merge_top2_kernel(int const*)": (0.1, 16)},
}


def _config(name):
    return harness.load_json(harness.HERE / "configs" / f"{name}.json")


def _reader(name):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py")


def _ctx(config, trace):
    return types.SimpleNamespace(
        driver=types.SimpleNamespace(config=config),
        trace=trace,
        window=types.SimpleNamespace(seconds=6.0, units=100, requests=100),
        roofline=lambda kernel: harness.load_module(
            harness.HERE / "rooflines" / f"{kernel}.py"))


def _trace(ops, busy_s, requests=16):
    return {"ops": ops, "requests": requests, "busy_s": busy_s}


@pytest.mark.parametrize("config,ms,places", [("kitti_orb_map", 0.9335, 4),
                                              ("kitti11_orb_map", 4.769, 3)])
def test_least_time_of_a_query(config, ms, places):
    """The forward search of N1 x (frames x slots) and, with the
    cross-check, the reverse of N1 x N1, each bound by the b1 product;
    without the cross-check exactly one N1 x N1 term less."""
    conf = _config(config)
    least = K2A.least_s(conf)
    assert round(least * 1e3, places) == ms
    n1, bits = conf["slots"], 32 * conf["words"]
    reverse = K2A.bound_s(n1, n1, bits)
    assert reverse == K2A.ops(n1, n1, bits) / K2A.B1_TENSOR_OPS_S
    assert K2A.least_s(dict(conf, cross_check=False)) == (
        K2A.bound_s(n1, conf["frames"] * n1, bits))
    assert least - K2A.least_s(dict(conf, cross_check=False)) == (
        pytest.approx(reverse, rel=1e-9))


def test_the_rate_is_the_b1_tensor_cores():
    """0.61 BMMA of 65,536 operations per clock per SM, 132 SMs at
    1.98 GHz: 5.3x the INT8 tensor cores' published 1,979 TOP/s."""
    assert K2A.B1_TENSOR_OPS_S == pytest.approx(1.0448e16, rel=1e-4)
    assert K2A.B1_TENSOR_OPS_S / 1.979e15 == pytest.approx(5.28, abs=0.01)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("metric", SHARES)
def test_share_reads_the_busy_time_whatever_runs_it(metric, layout):
    """The share is the count over the busy time per traced query, the
    same whatever the search's kernels are called or however many there
    are."""
    config = _config("kitti_orb_map")
    ctx = _ctx(config, _trace(LAYOUTS[layout], busy_s=0.8))
    value = _reader(metric).read(ctx)
    assert value == pytest.approx(100 * K2A.least_s(config) * 16 / 0.8,
                                  rel=1e-12)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_overhead_is_the_wall_time_beyond_the_busy_time(layout):
    """60 ms of wall time a query in the window, 50 ms busy a traced
    query: 10 ms, whatever the kernels are called."""
    ctx = _ctx(_config("kitti_orb_map"), _trace(LAYOUTS[layout], busy_s=0.8))
    assert _reader("match_overhead_ms").read(ctx) == pytest.approx(10.0)


@pytest.mark.parametrize("trace", [None, _trace({}, 0.0),
                                   _trace(LAYOUTS["knn2"], 0.0)],
                         ids=["no_trace", "nothing_ran", "busy_0"])
@pytest.mark.parametrize("metric", BUSY_READERS)
def test_no_trace_or_no_busy_time_reads_nothing(metric, trace):
    ctx = _ctx(_config("kitti_orb_map"), trace)
    assert _reader(metric).read(ctx) is None


@pytest.mark.parametrize("path", sorted(
    p.relative_to(harness.HERE).as_posix()
    for d in ("metrics", "rooflines")
    for p in (harness.HERE / d).glob("*.py")))
def test_no_reader_selects_device_time_by_a_kernel_name(path):
    """No reader or roofline picks ops out of the trace by name, so a
    kernel renamed, split or merged reads the same work."""
    src = (harness.HERE / path).read_text()
    assert '["ops"]' not in src and "KERNEL" not in src
    assert "re.compile" not in src
