"""Correspondence filters (port of ``ops/filters.py``): GMS grid voting
and the GMBSOF statistical-flow subset.

GMS (Grid-based Motion Statistics, gms.cpp:54-84): matches scatter-added
into a (G^2, G^2) cell-pair histogram, each pair scored by its 9 aligned
neighbour cells and thresholded at alpha * sqrt(mean support), over 4
half-cell grid offsets. The SOF (Statistical Optical Flow) field of GMbSOF
(match_statOptFlow.cpp:2608 getStatisticalMatchingPositions, :2266
interpolStatOptFlow, :4410 guidedMatching): per-grid-cell robust flow
statistics with dual validation, a stats-over-stats band filter, field
fill, and the predicted position + search radius per query keypoint, plus
the seed-kNN fallback for sparse seeds. Fixed-shape and mask-aware.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from matchinglib_poselib_torch.ops import geometry as geo
from matchinglib_poselib_torch.ops.geometry import floor_mod

_TWO_PI = 2.0 * math.pi


class SOFField(NamedTuple):
    """Per-cell flow statistics on a (gy, gx) grid."""

    flow: torch.Tensor  # (gy, gx, 2) median flow (dx, dy)
    radius: torch.Tensor  # (gy, gx) search/uncertainty radius
    valid: torch.Tensor  # (gy, gx) bool


def autoth_validation_th(inlier_ratio, binary: bool) -> torch.Tensor:
    """AUTOTH validation threshold from the estimated inlier ratio
    (match_statOptFlow.cpp:766-801)."""
    r = torch.as_tensor(inlier_ratio, dtype=torch.float32)
    if binary:
        mid = torch.clamp(1.5 * r + 0.075, max=0.75)
        return torch.where(r >= 0.45, 0.75, torch.where(r <= 0.15, 0.3, mid))
    return torch.clamp(r, 0.3, 0.75)


# ---------------------------------------------------------------------------
# GMS
# ---------------------------------------------------------------------------

# the 4 half-cell grid shifts of GMS
GMS_OFFSETS = ((0.0, 0.0), (0.5, 0.0), (0.0, 0.5), (0.5, 0.5))


def gms_filter(pts1: torch.Tensor, pts2: torch.Tensor, mask: torch.Tensor,
               shape1: tuple[int, int], shape2: tuple[int, int],
               grid: int = 20, alpha: float = 6.0) -> torch.Tensor:
    """Grid-based motion statistics inlier mask.

    pts1, pts2: (N, 2) pixel coords of matched pairs; mask: (N,) validity;
    shape = (height, width). Returns the refined (N,) bool mask. The cell
    counts are sums of 0/1 (``index_put_`` with accumulation), exact in
    any order.
    """
    keep = torch.zeros_like(mask, dtype=torch.bool)
    for ox, oy in GMS_OFFSETS:
        keep = keep | gms_offset_accept(pts1, pts2, mask, shape1, shape2,
                                        grid, alpha, ox, oy)
    return keep & mask.to(torch.bool)


def gms_offset_accept(pts1, pts2, mask, shape1, shape2, grid: int,
                      alpha: float, ox: float, oy: float) -> torch.Tensor:
    """GMS acceptance of every match on the grid shifted by (ox, oy) cells
    (masked matches are counted as absent but still looked up)."""
    h1, w1 = shape1
    h2, w2 = shape2
    dims = (0, 1, 2, 3)

    def coord(v, size, off):
        # v / size * grid + off as the JAX package's compiled filter
        # evaluates it: XLA folds the division into a product with the f32
        # constant f32(1 / size) * grid and contracts the add into an FMA;
        # the float64 product of two f32 values is exact
        c = float(np.float32(np.float32(1.0) / np.float32(size))
                  * np.float32(grid))
        q = (v.to(torch.float64) * c + off).to(torch.float32)
        return torch.clamp(q.to(torch.int64), 0, grid - 1)

    def cell(p, w, h, off_x, off_y):
        return coord(p[:, 1], h, off_y) * grid + coord(p[:, 0], w, off_x)

    cell1 = cell(pts1, w1, h1, ox, oy)
    cell2 = cell(pts2, w2, h2, ox, oy)
    counts = torch.zeros((grid * grid, grid * grid), dtype=torch.float32,
                         device=pts1.device)
    counts.index_put_((cell1, cell2), mask.to(torch.float32),
                      accumulate=True)
    c4 = counts.reshape(grid, grid, grid, grid)
    occ = (c4 > 0).to(torch.float32)
    # score(a, b) = sum over the 9 aligned neighbour shifts
    score4 = torch.zeros_like(c4)
    support4 = torch.zeros_like(c4)  # contributing cell pairs
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            sh = (di, dj, di, dj)
            score4 = score4 + torch.roll(c4, shifts=sh, dims=dims)
            support4 = support4 + torch.roll(occ, shifts=sh, dims=dims)
    # GMS threshold: alpha * sqrt(mean matches per contributing cell)
    mean_per_cell = score4 / torch.clamp(support4, min=1.0)
    accept4 = score4 > alpha * torch.sqrt(mean_per_cell)
    return accept4.reshape(grid * grid, grid * grid)[cell1, cell2]


# ---------------------------------------------------------------------------
# partition statistics (cells partition the points)
# ---------------------------------------------------------------------------


def _partition_layout(cell: torch.Tensor, valid: torch.Tensor, C: int):
    """(ckey, counts, starts): cell key with invalid points mapped to C,
    per-cell sizes and their exclusive prefix."""
    ckey = torch.where(valid, cell, C).to(torch.int64)
    counts = torch.bincount(ckey, minlength=C + 1)[:C]
    starts = torch.cat([torch.zeros(1, dtype=counts.dtype,
                                    device=counts.device),
                        torch.cumsum(counts, 0)[:-1]])
    return ckey, counts, starts


def _partition_median(vals, ckey, counts, starts):
    """Per-cell medians of (N,) or (B, N) value rows over one partition
    (ckey/counts/starts from _partition_layout): one lexicographic
    (cell, value) sort per row (``lax.sort`` with num_keys=2), then the
    middle element(s) of each cell's run."""
    by_val = torch.argsort(vals, dim=-1, stable=True)
    keys = torch.gather(ckey.expand(vals.shape), -1, by_val)
    by_key = torch.argsort(keys, dim=-1, stable=True)
    vs = torch.gather(torch.gather(vals, -1, by_val), -1, by_key)
    N = vs.shape[-1]
    half = torch.clamp(counts - 1, min=0)
    lo = torch.clamp(starts + half // 2, 0, N - 1)
    hi = torch.clamp(starts + half // 2 + half % 2, 0, N - 1)
    shape = vs.shape[:-1] + lo.shape
    med = 0.5 * (torch.gather(vs, -1, lo.expand(shape))
                 + torch.gather(vs, -1, hi.expand(shape)))
    return torch.where(counts > 0, med, torch.zeros_like(med))


def _segment_sum_rows(vals, seg, C: int):
    """Row-wise segment sums of (B, N) values into C + 1 segments -> (B, C)."""
    out = torch.zeros(vals.shape[:-1] + (C + 1,), dtype=vals.dtype,
                      device=vals.device)
    return out.scatter_add_(-1, seg, vals)[..., :C]


def _partition_moments_batch(vals, cell, valid, C: int, trim: bool = True):
    """Batched per-cell (median, mean, std) over a shared partition, with
    the IQR trim of getStatisticfromVec (match_statOptFlow.cpp:4302)."""
    B, N = vals.shape
    ckey, counts, starts = _partition_layout(cell, valid, C)
    med = _partition_median(vals, ckey, counts, starts)
    cell_c = torch.clamp(cell, 0, C - 1).expand(B, N)
    keep = valid.expand(B, N)
    if trim:
        dev = torch.abs(vals - torch.gather(med, 1, cell_c))
        half = _partition_median(dev, ckey, counts, starts)
        keep = keep & (dev <= torch.gather(half, 1, cell_c) + 1e-6)
    kf = keep.to(torch.float32)
    seg = torch.where(keep, cell, C).to(torch.int64)
    n = torch.clamp(_segment_sum_rows(kf, seg, C), min=1.0)
    mean = _segment_sum_rows(vals * kf, seg, C) / n
    dv = vals - torch.gather(mean, 1, cell_c)
    s2 = _segment_sum_rows(dv * dv * kf, seg, C)
    return med, mean, torch.sqrt(s2 / n)


def _masked_moments(vals, member, trim: bool = True):
    """Per-row (median, mean, std) over masked entries; optional IQR trim."""
    med = geo.masked_median(vals, member)
    memberf = member.to(torch.float32)
    if trim:
        dev = torch.abs(vals - med[..., None])
        half = geo.masked_median(dev, member)
        memberf = (member & (dev <= half[..., None] + 1e-6)).to(torch.float32)
    n = torch.clamp(torch.sum(memberf, dim=-1), min=1.0)
    mean = torch.sum(vals * memberf, dim=-1) / n
    var = torch.sum((vals - mean[..., None]) ** 2 * memberf, dim=-1) / n
    return med, mean, torch.sqrt(var)


def _masked_circ_moments(ang, member, trim: bool = True):
    """Circular (median, mean, std) per row: both branch cuts (at 0 and
    at pi) evaluated, the one with the smaller dispersion kept
    (getAngularStatistic, match_statOptFlow.cpp:4177)."""
    a1 = floor_mod(ang, _TWO_PI)
    a2 = floor_mod(ang + math.pi, _TWO_PI)
    med1, mean1, std1 = _masked_moments(a1, member, trim)
    med2, mean2, std2 = _masked_moments(a2, member, trim)
    pick1 = std1 <= std2
    med = torch.where(pick1, med1, floor_mod(med2 - math.pi, _TWO_PI))
    mean = torch.where(pick1, mean1, floor_mod(mean2 - math.pi, _TWO_PI))
    std = torch.where(pick1, std1, std2)
    return med, mean, std


def _circ_diff(a, b):
    """Smallest absolute angular difference on the circle."""
    d = floor_mod(a - b, _TWO_PI)
    return torch.minimum(d, _TWO_PI - d)


def select_strongest_per_cell(
    xy: torch.Tensor, response: torch.Tensor, mask: torch.Tensor,
    shape: tuple[int, int], cell_px: int = 100, per_cell: int = 32,
) -> torch.Tensor:
    """Keep the `per_cell` strongest keypoints of every grid cell
    (get_Sparse_KeypointField, match_statOptFlow.cpp:5215)."""
    h, w = shape
    gy = max(1, (h + cell_px - 1) // cell_px)
    gx = max(1, (w + cell_px - 1) // cell_px)
    n = xy.shape[0]
    maskb = mask.to(torch.bool)
    cx = torch.clamp((xy[:, 0] / cell_px).to(torch.int64), 0, gx - 1)
    cy = torch.clamp((xy[:, 1] / cell_px).to(torch.int64), 0, gy - 1)
    cell = torch.where(maskb, cy * gx + cx, gy * gx)
    resp = torch.where(maskb, response, -torch.inf)
    by_resp = torch.argsort(-resp, stable=True)
    by_cell = torch.argsort(cell[by_resp], stable=True)
    order = by_resp[by_cell]
    cs = cell[order]
    pos = torch.arange(n, device=xy.device)
    is_new = torch.cat([torch.ones(1, dtype=torch.bool, device=xy.device),
                        cs[1:] != cs[:-1]])
    seg_start = torch.cummax(torch.where(is_new, pos, 0), 0).values
    keep_sorted = (pos - seg_start) < per_cell
    keep = torch.zeros(n, dtype=torch.bool, device=xy.device)
    keep[order] = keep_sorted
    return keep & maskb


def sof_statistics(
    pts1: torch.Tensor,
    pts2: torch.Tensor,
    mask: torch.Tensor,
    shape: tuple[int, int],
    cell_px: int = 100,
    validation_th=0.3,
    min_per_cell: int = 8,
    std_mult: float = 3.5,
) -> SOFField:
    """Per-cell robust flow statistics + dual validation + fill/smooth
    (getStatisticalMatchingPositions, match_statOptFlow.cpp:2608; see the
    JAX package's docstring for the reference line map)."""
    h, w = shape
    dev = pts1.device
    gy = max(1, (h + cell_px - 1) // cell_px)
    gx = max(1, (w + cell_px - 1) // cell_px)
    C = gy * gx
    maskb = mask.to(torch.bool)
    std_mult = min(max(std_mult, 1.0), 7.0)
    vth = torch.clamp(
        torch.as_tensor(validation_th, dtype=torch.float32, device=dev),
        0.1, 1.0,
    )

    cx = torch.clamp((pts1[:, 0] / cell_px).to(torch.int64), 0, gx - 1)
    cy = torch.clamp((pts1[:, 1] / cell_px).to(torch.int64), 0, gy - 1)
    cell = cy * gx + cx

    flow = pts2 - pts1
    n_cell = _partition_layout(cell, maskb, C)[1].to(torch.float32)
    mag = torch.linalg.norm(flow, dim=-1)
    ang = floor_mod(torch.atan2(flow[:, 1], flow[:, 0]), _TWO_PI)

    a1 = ang
    a2 = floor_mod(ang + math.pi, _TWO_PI)
    med3, mean3, std3 = _partition_moments_batch(
        torch.stack([mag, a1, a2]), cell, maskb, C
    )
    d_med, d_mean = med3[0], mean3[0]
    pick1 = std3[1] <= std3[2]
    a_med = torch.where(pick1, med3[1], floor_mod(med3[2] - math.pi, _TWO_PI))
    a_mean = torch.where(pick1, mean3[1],
                         floor_mod(mean3[2] - math.pi, _TWO_PI))

    d_diff = torch.abs(d_mean - d_med)
    dist_fail = (d_diff / (d_mean + 0.1) > vth) & (d_diff > 0.5)
    a_diff = _circ_diff(a_mean, a_med) / math.pi
    ang_fail = a_diff > (vth / 6.0)
    enough = n_cell >= min_per_cell
    valid = enough & ~dist_fail & ~ang_fail
    # AUTOTH retry (:806-825): zero validated cells -> strict threshold 0.3
    fb_dist_fail = (d_diff / (d_mean + 0.1) > 0.3) & (d_diff > 0.5)
    fb_ang_fail = a_diff > 0.05
    valid_fb = enough & ~fb_dist_fail & ~fb_ang_fail
    valid = torch.where(torch.any(valid), valid, valid_fb)

    # stats-over-stats over the validated cells' medians
    _, g_ang_mean, g_ang_std = _masked_circ_moments(
        a_med[None, :], valid[None, :], trim=False
    )
    _, g_d_mean, g_d_std = _masked_moments(
        d_med[None, :], valid[None, :], trim=False
    )
    g_ang_mean, g_ang_std = g_ang_mean[0], g_ang_std[0]
    g_d_mean, g_d_std = g_d_mean[0], g_d_std[0]
    min_std_ang = 1.07 * torch.atan(1.0 / (g_d_mean + 0.1)) / 4.0
    g_ang_std = torch.maximum(g_ang_std, min_std_ang)
    g_d_std = torch.clamp(g_d_std, min=0.5)

    in_band = (
        (_circ_diff(ang, g_ang_mean) <= 4.0 * g_ang_std)
        & (torch.abs(mag - g_d_mean) <= 4.0 * g_d_std)
    )
    any_band = torch.any(in_band & maskb)
    valid2 = maskb & torch.where(any_band, in_band, maskb)
    ckey2, counts2, starts2 = _partition_layout(cell, valid2, C)
    n2 = counts2.to(torch.float32)

    med_b = _partition_median(
        torch.stack([flow[:, 0], flow[:, 1], mag]), ckey2, counts2, starts2
    )
    med_dx, med_dy, med_mag2 = med_b[0], med_b[1], med_b[2]
    cmed = torch.stack([med_dx, med_dy], dim=-1)
    dev_pt = torch.linalg.norm(flow - cmed[cell], dim=-1)
    mad = _partition_median(dev_pt, ckey2, counts2, starts2)
    sigma = 1.4826 * mad
    sigma_ok = sigma <= vth * torch.clamp(med_mag2, min=80.0)
    valid = valid & sigma_ok & (n2 >= min(min_per_cell, 2.0))

    cell_flow = torch.stack([med_dx, med_dy], dim=-1).reshape(gy, gx, 2)
    cell_rad = (std_mult * sigma + 4.0).reshape(gy, gx)
    validg = valid.reshape(gy, gx)

    yy, xx = torch.meshgrid(torch.arange(gy, device=dev),
                            torch.arange(gx, device=dev), indexing="ij")
    coords = torch.stack([yy, xx], dim=-1).reshape(C, 2).to(torch.float32)
    d2 = torch.sum((coords[:, None, :] - coords[None, :, :]) ** 2, dim=-1)
    wgt = torch.where(validg.reshape(1, C), 1.0 / (1.0 + d2), 0.0)
    wsum = torch.clamp(torch.sum(wgt, dim=1), min=1e-9)
    fill_flow = (wgt @ cell_flow.reshape(C, 2)) / wsum[:, None]
    fill_rad = (wgt @ cell_rad.reshape(C)) / wsum
    any_valid = torch.any(validg)
    flow_out = torch.where(
        validg.reshape(C, 1), cell_flow.reshape(C, 2), fill_flow
    ).reshape(gy, gx, 2)
    dmin = torch.sqrt(torch.amin(
        torch.where(validg.reshape(1, C), d2, torch.inf), dim=1
    ))
    rad_out = torch.where(
        validg.reshape(C), cell_rad.reshape(C),
        2.0 * fill_rad + 0.5 * cell_px * dmin,
    ).reshape(gy, gx)
    rad_out = torch.where(any_valid, rad_out, torch.full_like(rad_out, 1e6))
    return SOFField(flow=flow_out, radius=rad_out, valid=validg)


def sof_predict(field: SOFField, pts1: torch.Tensor, cell_px: int):
    """Predicted positions + radii via bilinear field lookup."""
    gy, gx = field.radius.shape
    fy = torch.clamp(pts1[:, 1] / cell_px - 0.5, 0.0, gy - 1.0)
    fx = torch.clamp(pts1[:, 0] / cell_px - 0.5, 0.0, gx - 1.0)
    y0 = torch.floor(fy).to(torch.int64)
    x0 = torch.floor(fx).to(torch.int64)
    y1 = torch.clamp(y0 + 1, max=gy - 1)
    x1 = torch.clamp(x0 + 1, max=gx - 1)
    wy = fy - y0
    wx = fx - x0

    def lerp(arr):
        a, b = arr[y0, x0], arr[y0, x1]
        c, d = arr[y1, x0], arr[y1, x1]
        if arr.ndim == 3:
            wy_, wx_ = wy[:, None], wx[:, None]
        else:
            wy_, wx_ = wy, wx
        return (a * (1 - wy_) * (1 - wx_) + b * (1 - wy_) * wx_
                + c * wy_ * (1 - wx_) + d * wy_ * wx_)

    return pts1 + lerp(field.flow), lerp(field.radius)


def sof_cell_valid_at(field: SOFField, pts: torch.Tensor, cell_px: int):
    """Whether each query point's grid cell validated."""
    gy, gx = field.radius.shape
    cx = torch.clamp((pts[:, 0] / cell_px).to(torch.int64), 0, gx - 1)
    cy = torch.clamp((pts[:, 1] / cell_px).to(torch.int64), 0, gy - 1)
    return field.valid[cy, cx]


def sof_predict_knn(
    seed_pts1: torch.Tensor,
    seed_flow: torch.Tensor,
    seed_mask: torch.Tensor,
    query_pts: torch.Tensor,
    k: int = 8,
    std_mult: float = 3.5,
):
    """Seed-kNN flow prediction, the sparse-seed fallback of the SOF field:
    median flow of the k nearest seed matches, radius std_mult * robust
    dispersion grown with the neighbourhood's extent.

    Returns (pred (N, 2), rad (N,), ok (N,) bool). The JAX package's
    ``approx_max_k`` is exact off-TPU; this is the exact top-k.
    """
    seedb = seed_mask.to(torch.bool)
    n_seed = torch.sum(seedb)
    d2 = torch.sum(
        (query_pts[:, None, :] - seed_pts1[None, :, :]) ** 2, dim=-1
    )
    d2 = torch.where(seedb[None, :], d2, torch.inf)
    neg, idx = geo.topk_stable(-d2, k)
    ndist = torch.sqrt(torch.clamp(-neg, min=0.0))
    nvalid = torch.isfinite(neg)
    nflow = seed_flow[idx]
    big = 1e9
    fx = torch.where(nvalid, nflow[..., 0], big)
    fy = torch.where(nvalid, nflow[..., 1], big)
    nv = torch.clamp(torch.sum(nvalid, dim=1), min=1)

    def masked_med(v):
        s = torch.sort(v, dim=1).values
        lo = torch.gather(s, 1, ((nv - 1) // 2)[:, None])[:, 0]
        hi = torch.gather(s, 1, ((nv - 1) // 2 + (nv - 1) % 2)[:, None])[:, 0]
        return 0.5 * (lo + hi)

    med = torch.stack([masked_med(fx), masked_med(fy)], dim=-1)
    dev = torch.linalg.norm(
        torch.where(nvalid[..., None], nflow - med[:, None, :], 0.0), dim=-1
    )
    sigma = 1.4826 * masked_med(torch.where(nvalid, dev, big))
    far = torch.where(nvalid, ndist, 0.0).amax(dim=1)
    pred = query_pts + med
    rad = std_mult * sigma + 4.0 + 0.15 * far
    ok = (n_seed >= 3) & torch.any(nvalid, dim=1)
    return pred, rad, ok
