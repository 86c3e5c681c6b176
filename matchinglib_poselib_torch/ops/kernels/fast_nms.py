"""Fused FAST-9/16 score + NMS: CUDA kernel wrapper and its plain version.

Replaces ``matchinglib_poselib_tpu/ops/pallas/fast.py`` (Pallas kernel of
``fast_nms_score_batch``). The kernel is ``csrc/fast_nms.cu``; its plain
PyTorch version is ``fast_nms_score_plain`` = ``nms(fast_score(.))`` of
``ops/features.py``. On a CPU tensor the wrapper runs the plain version; on
a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from matchinglib_poselib_torch.ops.kernels import _build
from matchinglib_poselib_torch.utils import profiling

# largest NMS radius the kernel is built for (as the Pallas kernel's halo)
MAX_RADIUS = 5


def fast_nms_score_plain(
    imgs: torch.Tensor, threshold: float, radius: int = 3
) -> torch.Tensor:
    """nms(fast_score(imgs, threshold), radius) over the last two axes.

    Ring samples wrap at the border, so this equals the kernel at every
    pixel further than radius + 3 from the border.
    """
    from matchinglib_poselib_torch.ops import features

    return features.nms(features.fast_score(imgs, threshold), radius)


def fast_nms_score(
    imgs: torch.Tensor, threshold: float, radius: int = 3
) -> torch.Tensor:
    """FAST-9/16 score with fused NMS: (B, H, W) float32 -> same.

    threshold in intensity units of the [0, 1] image (fast_threshold/255),
    any finite value (its sign picks the kernel's instantiation). On a
    CUDA tensor the radius is 0..MAX_RADIUS, as the Pallas kernel asserts.
    """
    if imgs.device.type == "cpu":
        return fast_nms_score_plain(imgs, threshold, radius)
    if imgs.device.type != "cuda":
        raise ValueError(f"fast_nms_score: unsupported device {imgs.device}")
    if imgs.dtype != torch.float32 or imgs.ndim != 3:
        raise ValueError(
            "fast_nms_score: expects a (B, H, W) float32 tensor, got "
            f"{tuple(imgs.shape)} {imgs.dtype}"
        )
    if not imgs.is_contiguous():
        raise ValueError("fast_nms_score: input must be contiguous")
    if not 0 <= radius <= MAX_RADIUS:
        raise ValueError(
            f"fast_nms_score: radius {radius} outside 0..{MAX_RADIUS} on the "
            "card"
        )
    lib = _build.load("fast_nms")
    B, H, W = imgs.shape
    out = torch.empty_like(imgs)
    if imgs.numel() == 0:
        return out
    with torch.cuda.device(imgs.device):
        stream = torch.cuda.current_stream(imgs.device).cuda_stream
        rc = lib.fast_nms_launch(
            imgs.data_ptr(), out.data_ptr(), B, H, W, float(threshold),
            int(radius), stream,
        )
    _build.check(lib, "fast_nms", rc)
    profiling.count("fast_nms.launches")
    return out
