"""Hand-written CUDA kernels of the port and their launch counters.

Each wrapper counts its own kernel launches in a plain integer attribute
(``fast_nms.fast_nms_score.launches``, ``knn2.knn2.launches``,
``knn2.knn2_l2.launches``); CPU tensors run the plain versions and count
nothing.
"""

from __future__ import annotations

from matchinglib_poselib_torch.ops.kernels import fast_nms, knn2

WRAPPERS = {
    "fast_nms": fast_nms.fast_nms_score,
    "knn2": knn2.knn2,
    "knn2_l2": knn2.knn2_l2,
}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
