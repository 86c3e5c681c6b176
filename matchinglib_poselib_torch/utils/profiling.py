"""Stage timing and host-sync counting (port of ``utils/profiling.py``).

``StageTimer`` accumulates wall-clock milliseconds per stage with the
reference's stage names (timeMeasurements, noMatch_poselib-test/main.cpp:
61-73; correspondences.cpp:221-240). On CUDA, a stage ends with
``torch.cuda.synchronize()`` so device work is charged to the stage that
launched it, the role ``block_until_ready`` plays in the JAX package.

``HostSyncs`` counts the host reads of device values: the data-dependent
loop exits (the JAX package's ``lax.while_loop`` exits) and the values
the streaming framework's decisions read on the host (``fetch``): one
sync each.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any

import torch

class HostSyncs:
    """Count of host reads of device values."""

    count = 0

    @classmethod
    def read(cls, flag: torch.Tensor) -> bool:
        cls.count += 1
        return bool(flag)

    @classmethod
    def fetch(cls, x: torch.Tensor):
        """A tensor's values as a numpy array on the host."""
        cls.count += 1
        return x.detach().cpu().numpy()


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

    @contextlib.contextmanager
    def stage(self, name: str, outputs: Any = None):
        t0 = time.perf_counter()
        holder: dict[str, Any] = {}
        try:
            yield holder
        finally:
            _sync(holder.get("outputs", outputs))
            dt = (time.perf_counter() - t0) * 1e3
            self.times_ms[name] = self.times_ms.get(name, 0.0) + dt
            if self.verbose >= 3:
                print(f"[{name}] {dt:.2f} ms")

    def reset(self) -> None:
        self.times_ms.clear()
