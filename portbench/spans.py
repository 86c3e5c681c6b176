"""The program's own spans and counters (``matchinglib_poselib_torch.
utils.profiling``), as the metric readers take them. The program's spans
record only while torch.profiler does, so they hold the traced requests
alone; its counters are always on. Every function returns None where the
program has no such span or counter."""

from __future__ import annotations


def _profiling():
    from matchinglib_poselib_torch.utils import profiling

    return profiling


def _span(name: str):
    totals = getattr(_profiling(), "span_totals", None)
    return totals().get(name) if totals else None


def span_mean(name: str, key: str):
    """The span's `key` ("host_ms" or "device_ms") summed over its runs,
    over its count."""
    rec = _span(name)
    if not rec or not rec["count"] or rec[key] is None:
        return None
    return rec[key] / rec["count"]


def span_count(name: str):
    rec = _span(name)
    return rec["count"] if rec else None


def counter(name: str):
    counters = getattr(_profiling(), "counters", None)
    return counters().get(name) if counters else None
