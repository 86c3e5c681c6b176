"""Sub-pixel refinement of matched keypoint positions (port of
``ops/subpix.py``).

getSubPixMatches (matchers.cpp:1085-1317): a template around the left
point, sampled at half-pixel pitch (the reference's 2x upscaling), is
matched inside a search window around the right point; the best shift
moves the right point, and the whole pass is rejected when too few
matches refine. All matches refine at once: the SSD surface over every
shift is sum T^2 + box(S^2) - 2 corr(S, T), the correlation and the box
sum as grouped convolutions (one group per match), then a 1D parabola fit
along each axis.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class SubpixResult(NamedTuple):
    pts2: torch.Tensor  # (N, 2) refined right-image coords
    shift: torch.Tensor  # (N, 2) shift in pixels
    success: torch.Tensor  # (N,) bool: this match refined
    pass_ok: torch.Tensor  # () bool: the whole pass accepted


def _sample_grid(img, cx, cy, n: int, pitch: float):
    """(N,) centers -> (N, n, n) bilinear patches at the given pixel
    pitch (the top-left corner clamped to the image before the gather)."""
    H, W = img.shape
    offs = (torch.arange(n, dtype=img.dtype, device=img.device)
            - (n - 1) / 2.0) * pitch
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
    return (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
            + v10 * (1 - fx) * fy + v11 * fx * fy)


def _parabola_peak(y_m, y_0, y_p):
    """Offset of the extremum of a 3-point parabola, in [-0.5, 0.5]."""
    denom = y_m - 2.0 * y_0 + y_p
    curved = torch.abs(denom) > 1e-12
    off = 0.5 * (y_m - y_p) / torch.where(curved, denom, 1.0)
    return torch.clamp(torch.where(curved, off, 0.0), -0.5, 0.5)


def refine_matches_subpix(
    img1: torch.Tensor,
    img2: torch.Tensor,
    pts1: torch.Tensor,
    pts2: torch.Tensor,
    mask: torch.Tensor,
    template: int = 11,
    search: int = 21,
    min_success_ratio: float = 0.5,
) -> SubpixResult:
    """Template-matching sub-pixel refinement of pts2 (matchers.cpp:1085).

    template / search: patch sizes in half-pixel samples, so 11 covers
    5 x 5 px and 21 allows shifts of up to +-2.5 px. A match succeeds when
    its SSD minimum is inside the window and the surface has contrast; the
    pass keeps the original points unless at least ``min_success_ratio``
    of the valid matches succeed (a tensor decision, no host read).
    """
    dtype = img1.dtype
    maskb = mask.to(torch.bool)
    n = pts1.shape[0]
    pitch = 0.5

    T = _sample_grid(img1, pts1[:, 0], pts1[:, 1], template, pitch)
    S = _sample_grid(img2, pts2[:, 0], pts2[:, 1], search, pitch)
    # zero-mean patches (brightness-offset invariant)
    T = T - torch.mean(T, dim=(1, 2), keepdim=True)
    S = S - torch.mean(S, dim=(1, 2), keepdim=True)

    k = search - template + 1
    sum_t2 = torch.sum(T * T, dim=(1, 2))[:, None, None]
    ones = torch.ones((n, 1, template, template), dtype=dtype,
                      device=img1.device)
    S4 = S[None]
    box_s2 = F.conv2d(S4 * S4, ones, groups=n)[0]
    corr = F.conv2d(S4, T[:, None], groups=n)[0]
    ssd = sum_t2 + box_s2 - 2.0 * corr  # (N, k, k)

    flat = ssd.reshape(n, k * k)
    best = torch.argmin(flat, dim=1)
    by = best // k
    bx = best % k
    c = (k - 1) // 2

    # parabola refinement along each axis (clamped at the window border)
    ym = torch.clamp(by, 1, k - 2)
    xm = torch.clamp(bx, 1, k - 2)
    rows = torch.arange(n, device=img1.device)
    off_y = _parabola_peak(ssd[rows, ym - 1, bx], ssd[rows, ym, bx],
                           ssd[rows, ym + 1, bx])
    off_x = _parabola_peak(ssd[rows, by, xm - 1], ssd[rows, by, xm],
                           ssd[rows, by, xm + 1])
    shift = torch.stack([(bx.to(dtype) - c + off_x) * pitch,
                         (by.to(dtype) - c + off_y) * pitch], dim=1)

    interior = (by > 0) & (by < k - 1) & (bx > 0) & (bx < k - 1)
    contrast = (torch.amax(flat, dim=1) - torch.amin(flat, dim=1)) > 1e-8
    success = maskb & interior & contrast
    n_valid = torch.clamp(torch.sum(maskb.to(torch.float32)), min=1.0)
    pass_ok = (torch.sum(success.to(torch.float32)) / n_valid
               ) >= min_success_ratio
    new_pts2 = torch.where((success & pass_ok)[:, None], pts2 + shift, pts2)
    return SubpixResult(pts2=new_pts2, shift=shift, success=success,
                        pass_ok=pass_ok)
