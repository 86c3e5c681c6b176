"""Stage timing and host-sync counting (port of ``utils/profiling.py``).

``StageTimer`` accumulates wall-clock milliseconds per stage with the
reference's stage names (timeMeasurements, noMatch_poselib-test/main.cpp:
61-73; correspondences.cpp:221-240). On CUDA, a stage ends with
``torch.cuda.synchronize()`` so device work is charged to the stage that
launched it, the role ``block_until_ready`` plays in the JAX package.

``HostSyncs`` counts the host reads of device values: the data-dependent
loop exits (the JAX package's ``lax.while_loop`` exits) and the values
the streaming framework's decisions read on the host (``fetch``): one
sync each. Inside ``HostSyncs.traced()`` every read also notes its site
and the loop iteration it ends; ``loop_iterations`` turns that log into
the iterations of each run of each loop. ``trace`` records a block
under ``torch.profiler`` into a Chrome trace.

One registry of spans and counters serves the whole port. ``span(name,
on)`` costs one flag check unless ``torch.profiler`` is recording.
While the profiler records, a span opens a
``record_function`` range of its name (its record in the profiler's
trace, nested under the spans that hold it), adds its host-clock
milliseconds to the name's sum and, where `on` holds a CUDA tensor,
records a pair of timing events on that device's current stream: read
without waiting once the card has passed them, and all at once (one
synchronize) by ``span_totals``; read events are reused. The spans:
``sharded_match``'s ``knn.sharded_match``, ``knn.forward``, ``knn.merge``
and ``knn.reverse``, and a 2-NN call's merge of its column chunks past
one launch (``knn2.chunk_merge``, ``knn2_l2.chunk_merge``). ``count(name,
n)`` is always on: the kernels' launches, the launches of a 2-NN call
past one launch (``knn2.chunks``, ``knn2_l2.chunks``), the collectives
and their bytes, the host syncs, the rows ``sharded_match`` searches in
reverse (``knn.reverse_rows``).
"""

from __future__ import annotations

import contextlib
import time
from typing import Any

import torch

# the reference's stage names (timeMeasurements, noMatch_poselib-test/
# main.cpp:61-73, and the matching stages of correspondences.cpp)
STAGES = (
    "keypoints",
    "descriptors",
    "matching",
    "filtering",
    "robEstimationAndRef",
    "linRefinement",
    "bundleAdjust",
    "stereoRefine",
)


class HostSyncs:
    """Count of host reads of device values."""

    count = 0
    # (site, step) of every read while ``traced`` holds it, else None
    log: list | None = None

    @classmethod
    def _note(cls, site: str | None, step: int) -> None:
        cls.count += 1
        count("host_syncs")
        if cls.log is not None:
            cls.log.append((site, step))

    @classmethod
    def read(cls, flag: torch.Tensor, site: str | None = None,
             step: int = 0) -> bool:
        """`flag` on the host. site: the loop that reads it; step: the
        iteration it ends (0 starts a run of that loop)."""
        cls._note(site, step)
        return bool(flag)

    @classmethod
    def fetch(cls, x: torch.Tensor):
        """A tensor's values as a numpy array on the host."""
        cls._note("fetch", 0)
        return x.detach().cpu().numpy()

    @classmethod
    @contextlib.contextmanager
    def traced(cls):
        """Log the reads made inside the block; yields the log."""
        outer, cls.log = cls.log, []
        try:
            yield cls.log
        finally:
            cls.log = outer


def loop_iterations(log: list) -> dict:
    """{(site, k): iterations} of the k-th run (from 1) of each loop in a
    ``HostSyncs.traced`` log."""
    runs: dict = {}
    out: dict = {}
    for site, step in log:
        if step == 0:
            runs[site] = runs.get(site, 0) + 1
        key = (site, runs.get(site, 1))
        out[key] = out.get(key, 0) + 1
    return out


def _cuda_device(x: Any):
    """The device of the first CUDA tensor in a (nested) tuple, or None."""
    if isinstance(x, torch.Tensor):
        return x.device if x.is_cuda else None
    if isinstance(x, (tuple, list)):
        for t in x:
            dev = _cuda_device(t)
            if dev is not None:
                return dev
    return None


def _sync(x: Any) -> None:
    dev = _cuda_device(x)
    if dev is not None:
        torch.cuda.synchronize(dev)


# {name: [spans, host ms, device ms or None]}
_spans: dict[str, list] = {}
# (name, device, start event, end event) of spans not yet folded, in the
# order they ended
_pending: list[tuple] = []
# {device: timing events already folded}, reused: under the profiler,
# creating an event costs the host more than recording one
_free_events: dict = {}
_counts: dict[str, int] = {}
_OFF = contextlib.nullcontext()


class _Span:
    """An open span while the profiler records (see ``span``)."""

    __slots__ = ("name", "dev", "range", "start", "t0")

    def __init__(self, name: str, dev):
        self.name, self.dev = name, dev

    def __enter__(self):
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        self.start = None
        if self.dev is not None:
            self.start = _event(self.dev)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        host_ms = (time.perf_counter() - self.t0) * 1e3
        rec = _spans.setdefault(self.name, [0, 0.0, None])
        rec[0] += 1
        rec[1] += host_ms
        if self.start is not None:
            end = _event(self.dev)
            if rec[2] is None:
                rec[2] = 0.0
            _pending.append((self.name, self.dev, self.start, end))
            _fold(wait=False)
        self.range.__exit__(*exc)
        return False


def _event(dev):
    """A timing event recorded on `dev`'s current stream."""
    free = _free_events.get(dev)
    ev = free.pop() if free else torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(dev))
    return ev


def span(name: str, on: Any = None):
    """A context manager that times the block as the span `name` while
    ``torch.profiler`` records, and does nothing otherwise. `on`: a tensor
    (or a nested tuple of them); where one is a CUDA tensor, the span's
    device time is taken on that device's current stream. Never
    synchronizes."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(name, _cuda_device(on))


def _fold(wait: bool) -> None:
    """Add the device time of pending spans to their sums and free their
    events for reuse: all of them (`wait`, after one synchronize per
    device), else the oldest ones up to the first still running."""
    if wait:
        for dev in {p[1] for p in _pending}:
            torch.cuda.synchronize(dev)
    done = 0
    for name, dev, start, end in _pending:
        if not (wait or end.query()):
            break
        _spans[name][2] += start.elapsed_time(end)
        _free_events.setdefault(dev, []).extend((start, end))
        done += 1
    del _pending[:done]


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name`."""
    _counts[name] = _counts.get(name, 0) + n


def span_totals() -> dict[str, dict]:
    """{span name: {"count", "host_ms", "device_ms"}} summed over every
    span so far; "device_ms" is None for a span that never ran on a card.
    Synchronizes once with each card that spans wait on."""
    _fold(wait=True)
    return {name: {"count": c, "host_ms": h, "device_ms": d}
            for name, (c, h, d) in _spans.items()}


def counters() -> dict[str, int]:
    return dict(_counts)


def reset(*names: str) -> None:
    """Clear every span and counter, or only the counters `names`."""
    if names:
        for name in names:
            _counts.pop(name, None)
        return
    _spans.clear()
    _pending.clear()
    _counts.clear()


class StageTimer:
    """Accumulates per-stage wall-clock milliseconds.

    Usage::

        timer = StageTimer(verbose=3)
        with timer.stage("matching") as h:
            result = match(...)
            h["outputs"] = result   # synchronized before the clock stops

    Stages may repeat; times accumulate. ``times_ms`` maps stage -> ms.
    """

    def __init__(self, verbose: int = 0):
        self.verbose = verbose
        self.times_ms: dict[str, float] = {}
        self._order: list[str] = []

    @contextlib.contextmanager
    def stage(self, name: str, outputs: Any = None):
        t0 = time.perf_counter()
        holder: dict[str, Any] = {}
        try:
            yield holder
        finally:
            _sync(holder.get("outputs", outputs))
            dt = (time.perf_counter() - t0) * 1e3
            if name not in self.times_ms:
                self._order.append(name)
            self.times_ms[name] = self.times_ms.get(name, 0.0) + dt
            if self.verbose >= 3:
                print(f"[{name}] {dt:.2f} ms")

    def row(self) -> dict[str, float]:
        """CSV-ready mapping with the reference column names (a missing
        stage is 0.0, as timeMeasurements default-initializes it)."""
        return {f"{s}_ms": round(self.times_ms.get(s, 0.0), 3)
                for s in STAGES}

    def total_ms(self) -> float:
        return sum(self.times_ms.values())

    def reset(self) -> None:
        self.times_ms.clear()
        self._order.clear()


@contextlib.contextmanager
def trace(log_dir: str | None):
    """Record the block under ``torch.profiler`` (every activity the build
    supports: the CPU, and the card where PyTorch has CUDA) and write a
    Chrome trace (``*.pt.trace.json``) into `log_dir`; does nothing when
    `log_dir` is None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import profile, tensorboard_trace_handler

    with profile(on_trace_ready=tensorboard_trace_handler(str(log_dir))):
        yield
