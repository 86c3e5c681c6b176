"""Device traces of a few requests after the window, by torch.profiler.

Two profiles of the same number of requests:

1. device activity only: the device's busy seconds (the union of its
   kernels', copies' and sets' intervals), the host-clock length of the
   traced requests, and the device operations by name. Host ops are not
   recorded, so the profiler slows the host as little as it can.
2. host and device: the idle gaps between device operations, each put
   down to what the host was doing when it began (the innermost range the
   driver annotated, such as ``sharded_match``, and the innermost host
   op). This profile slows the host, so its gaps serve only as labels.

A trace that records no device operation is taken again (now and then
one records none); if none does, the trace's numbers are None and the
metrics that read them are left out.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TRIES = 3
TOP = 10


def _profile(driver, first: int, requests: int, device, host: bool):
    """Chrome-trace events of requests first, ..., first + requests - 1
    and their host seconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] if device.type == "cuda" else []
    if host or not acts:
        acts.append(ProfilerActivity.CPU)
    tmp = tempfile.mkdtemp(prefix="portbench-trace-")
    try:
        sync = (lambda: torch.cuda.synchronize(device)) \
            if device.type == "cuda" else (lambda: None)
        sync()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for i in range(first, first + requests):
                driver.request(i, traced=True)
            sync()
            seconds = time.perf_counter() - t0
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return [e for e in events if e.get("ph") == "X"], seconds


def _device(events):
    return [e for e in events if e.get("cat") in DEVICE_CATS]


def busy_intervals(events) -> list[tuple[float, float]]:
    """Union of the device events' [ts, ts + dur] intervals (us), sorted."""
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in _device(events))
    merged: list[list[float]] = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def ops_by_name(events) -> dict[str, tuple[float, int]]:
    """{device op name: (seconds, count)}."""
    out: dict[str, list] = {}
    for e in _device(events):
        rec = out.setdefault(e["name"], [0.0, 0])
        rec[0] += float(e["dur"]) * 1e-6
        rec[1] += 1
    return {k: (v[0], v[1]) for k, v in out.items()}


def _innermost(events, cat: str, times: list[float]) -> list:
    """For each of the sorted `times`, the name of the innermost event of
    category `cat` that holds it (None where none does). Host events of one
    thread nest, so one sweep with a stack finds them all; the thread is
    the one with the most events of that category."""
    evs = [e for e in events if e.get("cat") == cat]
    if not evs:
        return [None] * len(times)
    tids: dict = {}
    for e in evs:
        tids[e.get("tid")] = tids.get(e.get("tid"), 0) + 1
    main = max(tids, key=tids.get)
    spans = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                     e["name"]) for e in evs if e.get("tid") == main),
                   key=lambda s: (s[0], -s[1]))
    out, stack, i = [], [], 0
    for t in times:
        while i < len(spans) and spans[i][0] <= t:
            while stack and stack[-1][1] < spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def idle_gaps(events) -> dict[str, float]:
    """{what the host was doing: idle seconds} over the gaps between the
    device's busy intervals, each put down to the host's state where it
    began."""
    busy = busy_intervals(events)
    gaps = [(a, b) for (_, a), (b, _) in zip(busy, busy[1:])]
    starts = [a for a, _ in gaps]
    regions = _innermost(events, "user_annotation", starts)
    ops = _innermost(events, "cpu_op", starts)
    out: dict[str, float] = {}
    for (a, b), region, op in zip(gaps, regions, ops):
        label = f"{region or 'outside'} | {op or 'python'}"[:120]
        out[label] = out.get(label, 0.0) + (b - a) * 1e-6
    return out


def _top(d: dict, key) -> list:
    return [[k, key(v)] for k, v in sorted(d.items(),
                                           key=lambda kv: -key(kv[1]))][:TOP]


def trace_requests(driver, requests: int, device, first: int) -> dict:
    """Profile `requests` requests at a time, numbered from `first` on,
    each request once (see the module's docstring)."""
    events, seconds = [], 0.0
    for _ in range(TRIES):
        events, seconds = _profile(driver, first, requests, device,
                                   host=False)
        first += requests
        if _device(events):
            break
    busy = busy_intervals(events)
    ops = ops_by_name(events)
    labelled = {}
    if busy:
        for _ in range(TRIES):
            host_events, _ = _profile(driver, first, requests, device,
                                      host=True)
            first += requests
            if _device(host_events):
                labelled = idle_gaps(host_events)
                break
    busy_s = sum(b - a for a, b in busy) * 1e-6
    return {
        "requests": requests,
        "units": requests * driver.units_per_request,
        "window_s": seconds,
        "busy_s": busy_s,
        "device_ops": sum(c for _, c in ops.values()) if ops else None,
        "ops": ops,
        "breakdown": {"device_ops": _top(ops, lambda v: v[0]),
                      "idle_gaps": _top(labelled, lambda v: v)},
    }
