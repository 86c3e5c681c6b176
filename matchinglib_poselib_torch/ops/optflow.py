"""Pyramidal Lucas-Kanade optical flow and the LK-guided matchers (port of
``ops/optflow.py``).

- ``lk_flow``: calc_opticalFlow (match_opticalflow.cpp:28-67),
  cv::calcOpticalFlowPyrLK with 3 pyramid levels, a 21x21 window, 20
  iterations, eps 0.013 and an error gate of 0.05.
- ``match_lkof`` (LKOF, :71-148): each previous keypoint predicted into
  the next image, matched to the nearest next keypoint within the search
  radius. The coordinates are the descriptors: a float 2-NN at D = 2,
  the float 2-NN kernel (``kernels.knn2.knn2_l2``) on a CUDA tensor.
- ``match_alkof`` (ALKOF, :150-205): the least Hamming distance among the
  next keypoints inside the radius around the LK prediction, gated by
  ``max_hamm``: the binary 2-NN kernel (``kernels.knn2.knn2``) with its
  radius gate.
- ``track_lkoft`` (LKOFT / ALKOFT, :209+): the predicted positions
  become the next frame's keypoints.

All points advance together: window gathers, structure tensors and the
LK updates are batched tensors; the pyramid walk and the 20 iterations
are fixed loops that read nothing on the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from matchinglib_poselib_torch.ops import matching


class FlowResult(NamedTuple):
    pts: torch.Tensor  # (N, 2) predicted positions in the next image
    status: torch.Tensor  # (N,) bool: tracking succeeded
    err: torch.Tensor  # (N,) mean absolute window residual


_BINOMIAL = (1.0, 4.0, 6.0, 4.0, 1.0)


def _blur_downsample(img: torch.Tensor) -> torch.Tensor:
    """5-tap binomial blur (edge padding) and 2x decimation: one pyramid
    level down."""
    k = torch.tensor(_BINOMIAL, dtype=img.dtype, device=img.device) / 16.0

    def conv1d(x, axis):
        n = x.shape[axis]
        # edge padding by 2: clamped source indices
        src = torch.clamp(torch.arange(-2, n + 2, device=x.device), 0, n - 1)
        xp = torch.index_select(x, axis, src)
        out = torch.zeros_like(x)
        for i in range(5):
            out = out + k[i] * xp.narrow(axis, i, n)
        return out

    return conv1d(conv1d(img, 0), 1)[::2, ::2]


def gaussian_pyramid(img: torch.Tensor, levels: int) -> list:
    """[level 0 = img, level 1 = half, ...], finest first."""
    pyr = [img]
    for _ in range(levels - 1):
        pyr.append(_blur_downsample(pyr[-1]))
    return pyr


def _sample_windows(img, cx, cy, win):
    """(N,) centres -> (N, win, win) bilinear windows at a 1 px pitch."""
    H, W = img.shape
    offs = torch.arange(win, dtype=img.dtype, device=img.device) - (
        win - 1) / 2.0
    gx = cx[:, None, None] + offs[None, None, :]
    gy = cy[:, None, None] + offs[None, :, None]
    x0 = torch.clamp(torch.floor(gx), 0, W - 2).to(torch.int64)
    y0 = torch.clamp(torch.floor(gy), 0, H - 2).to(torch.int64)
    fx = torch.clamp(gx - x0, 0.0, 1.0)
    fy = torch.clamp(gy - y0, 0.0, 1.0)
    v00 = img[y0, x0]
    v01 = img[y0, x0 + 1]
    v10 = img[y0 + 1, x0]
    v11 = img[y0 + 1, x0 + 1]
    return (
        v00 * (1 - fx) * (1 - fy)
        + v01 * fx * (1 - fy)
        + v10 * (1 - fx) * fy
        + v11 * fx * fy
    )


def _lk_level(img_prev, img_next, pts, flow, win, iters, eps):
    """One pyramid level of LK: refine `flow` for every point. Returns
    (flow, err, invertible)."""
    cx, cy = pts[:, 0], pts[:, 1]
    # template and its gradients (central differences of bilinear samples)
    T = _sample_windows(img_prev, cx, cy, win)
    Ix = 0.5 * (_sample_windows(img_prev, cx + 1.0, cy, win)
                - _sample_windows(img_prev, cx - 1.0, cy, win))
    Iy = 0.5 * (_sample_windows(img_prev, cx, cy + 1.0, win)
                - _sample_windows(img_prev, cx, cy - 1.0, win))
    gxx = torch.sum(Ix * Ix, dim=(1, 2))
    gxy = torch.sum(Ix * Iy, dim=(1, 2))
    gyy = torch.sum(Iy * Iy, dim=(1, 2))
    det = gxx * gyy - gxy * gxy
    inv_ok = det > 1e-12
    det_safe = torch.where(inv_ok, det, 1.0)
    for _ in range(iters):
        S = _sample_windows(img_next, cx + flow[:, 0], cy + flow[:, 1], win)
        d = T - S
        bx = torch.sum(Ix * d, dim=(1, 2))
        by = torch.sum(Iy * d, dim=(1, 2))
        dx = (gyy * bx - gxy * by) / det_safe
        dy = (gxx * by - gxy * bx) / det_safe
        step = torch.stack([dx, dy], dim=1)
        small = torch.sum(step * step, dim=1, keepdim=True) < eps * eps
        flow = flow + torch.where(inv_ok[:, None] & ~small, step, 0.0)
    S = _sample_windows(img_next, cx + flow[:, 0], cy + flow[:, 1], win)
    err = torch.mean(torch.abs(T - S), dim=(1, 2))
    return flow, err, inv_ok


def lk_flow(img_prev: torch.Tensor, img_next: torch.Tensor,
            pts: torch.Tensor, mask: torch.Tensor, levels: int = 3,
            win: int = 21, iters: int = 20, eps: float = 0.013,
            max_err: float = 0.05) -> FlowResult:
    """Pyramidal LK (calc_opticalFlow: 3 levels, 21x21, 20 iterations,
    eps 0.013, error gate 0.05; match_opticalflow.cpp:40,57-64).

    img_prev, img_next: (H, W) float32; pts: (N, 2) x, y; mask: (N,).
    """
    H, W = img_prev.shape
    pyr_prev = gaussian_pyramid(img_prev, levels)
    pyr_next = gaussian_pyramid(img_next, levels)
    flow = torch.zeros_like(pts)
    ok = mask.to(torch.bool)
    err = torch.zeros(pts.shape[0], dtype=pts.dtype, device=pts.device)
    for lvl in range(levels - 1, -1, -1):
        if lvl < levels - 1:
            flow = flow * 2.0
        flow, err, inv_ok = _lk_level(pyr_prev[lvl], pyr_next[lvl],
                                      pts / 2.0**lvl, flow, win, iters, eps)
        ok = ok & inv_ok
    out = pts + flow
    inside = ((out[:, 0] >= 0) & (out[:, 0] <= W - 1)
              & (out[:, 1] >= 0) & (out[:, 1] <= H - 1))
    return FlowResult(pts=out, status=ok & inside & (err < max_err),
                      err=err)


def match_lkof(kp_prev, kp_next, mask_prev, mask_next, img_prev, img_next,
               search_radius: float = 10.0) -> matching.MatchResult:
    """LKOF: the LK prediction's nearest next keypoint within the radius
    (match_opticalflow.cpp:134-148), by the exact float 2-NN over the
    coordinates (squared distances; no ratio test, no cross-check)."""
    fl = lk_flow(img_prev, img_next, kp_prev, mask_prev)
    return matching.match_descriptors(
        fl.pts, kp_next, mask_prev.to(torch.bool) & fl.status, mask_next,
        binary=False, ratio_test=False, cross_check=False,
        max_distance=search_radius * search_radius,
    )


def match_alkof(kp_prev, kp_next, desc_prev, desc_next, mask_prev,
                mask_next, img_prev, img_next, search_radius: float = 10.0,
                max_hamm: float = 60.0) -> matching.MatchResult:
    """ALKOF: the least Hamming distance among the next keypoints inside
    the radius around the LK prediction, gated by maxHammDist
    (match_opticalflow.cpp:150-205). desc_*: (N, W) int32 words."""
    fl = lk_flow(img_prev, img_next, kp_prev, mask_prev)
    rad = torch.full((kp_prev.shape[0],), search_radius,
                     dtype=kp_prev.dtype, device=kp_prev.device)
    return matching.match_descriptors(
        desc_prev, desc_next, mask_prev.to(torch.bool) & fl.status,
        mask_next, binary=True, ratio_test=False, cross_check=False,
        max_distance=max_hamm, guide_pred=fl.pts, guide_rad=rad,
        pts2_xy=kp_next.contiguous(),
    )


def track_lkoft(kp_prev, mask_prev, img_prev, img_next) -> FlowResult:
    """LKOFT / ALKOFT tracker core (getMatches_OpticalFlowTracker,
    match_opticalflow.cpp:209+): the predicted positions become the next
    frame's keypoints; re-extracting descriptors there is the caller's
    step, as in the reference."""
    return lk_flow(img_prev, img_next, kp_prev, mask_prev)
