"""Hand-written CUDA kernels of the port and their launch counters.

Each wrapper counts its own kernel launches in the port's counters
(``utils/profiling.count``): ``fast_nms.launches``, ``knn2.launches``,
``knn2_l2.launches``; CPU tensors run the plain versions and count
nothing.
"""

from __future__ import annotations

from matchinglib_poselib_torch.utils import profiling

KERNELS = ("fast_nms", "knn2", "knn2_l2")


def launch_counts() -> dict[str, int]:
    counts = profiling.counters()
    return {name: counts.get(f"{name}.launches", 0) for name in KERNELS}


def reset_launch_counts() -> None:
    profiling.reset(*(f"{name}.launches" for name in KERNELS))
