"""Stereo rectification and rectified-image generation (port of
``ops/rectify.py``).

The reference's rectification layer (all in poselib/source/pose_helper.cpp):

- getRectificationParameters (:1366) — dispatch + validation
- rectifyFusiello (:1459) — Fusiello-Trucco-Verri general-rig rectification
- stereoRectify2 / cvStereoRectify2 (:1900,1979) — robustified OpenCV-style
  rectification with disparity-to-depth Q matrix
- estimateOptimalFocalScale (:2561) — focal scale search keeping the
  rectified field of view tight
- ShowRectifiedImages / GetRectifiedImages (:2636,2775) — undistort+rectify
  remap of the input images

Both classic algorithms reduce to the same construction here: a common
rotation whose x-axis is the baseline, new shared intrinsics, per-camera
rectifying rotations R1 = Rn and R2 = Rn R^T (world = camera-1 frame,
x2 = R x1 + t). The remap is a dense gather over every output pixel at
once. Float32 tensors on the inputs' device; nothing reads the host.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from matchinglib_poselib_torch.ops import geometry as geo


class Rectification(NamedTuple):
    R1: torch.Tensor  # (3, 3) rectifying rotation, camera 1
    R2: torch.Tensor  # (3, 3) rectifying rotation, camera 2
    K_new1: torch.Tensor  # (3, 3) new intrinsics, camera 1
    K_new2: torch.Tensor  # (3, 3) new intrinsics, camera 2
    P1: torch.Tensor  # (3, 4) new projection, camera 1
    P2: torch.Tensor  # (3, 4) new projection, camera 2
    Q: torch.Tensor  # (4, 4) disparity-to-depth mapping
    baseline: torch.Tensor  # scalar |c2 - c1|


def _linspace_f32(start: float, stop: float, num: int) -> np.ndarray:
    """``jnp.linspace(start, stop, num)`` in float32 as XLA evaluates it:
    start (1 - s) + stop s with s = f32(i) / f32(num - 1), the second
    product fused into the add, the stop exact."""
    start, stop = np.float32(start), np.float32(stop)
    step = np.arange(num - 1, dtype=np.float32) / np.float32(num - 1)
    head = (start * (np.float32(1.0) - step)).astype(np.float32)
    fused = (np.float64(stop) * step.astype(np.float64)
             + head.astype(np.float64)).astype(np.float32)
    return np.append(fused, stop).astype(np.float32)


def _inv3(K: torch.Tensor) -> torch.Tensor:
    """Inverse of (..., 3, 3) K. An upper-triangular K (every camera
    matrix here) is inverted by back substitution with the reciprocals of
    its diagonal, the arithmetic of XLA's triangular solve behind the JAX
    package's ``jnp.linalg.inv``, so that both packages map a pixel to the
    same ray; any other K by LU (``inv_ex``: no host read)."""
    r0, r1, r2 = (1.0 / K[..., i, i] for i in range(3))
    x12 = -(K[..., 1, 2] * r2) * r1
    x01 = -(K[..., 0, 1] * r1) * r0
    x02 = -(K[..., 0, 1] * x12 + K[..., 0, 2] * r2) * r0
    z = torch.zeros_like(r0)
    upper_inv = torch.stack([torch.stack([r0, x01, x02], -1),
                             torch.stack([z, r1, x12], -1),
                             torch.stack([z, z, r2], -1)], -2)
    lower = torch.stack([K[..., 1, 0], K[..., 2, 0], K[..., 2, 1]], -1)
    upper = torch.all(lower == 0, dim=-1)[..., None, None]
    return torch.where(upper, upper_inv, torch.linalg.inv_ex(K).inverse)


def _mm(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A @ B for the rig's small matrices (..., m, k) and (..., k, n) or a
    k-vector, summed as XLA's CPU dot sums operands this small: a0 b0, then
    one fused multiply-add per further term (evaluated in float64, whose 53
    bits hold each f32 product exactly). The rectification then agrees with
    the JAX package's to the bit, on the card as on the CPU."""
    vec = B.ndim == 1
    if vec:
        B = B[:, None]
    a, b = A.to(torch.float64), B.to(torch.float64)
    acc = (a[..., :, 0:1] * b[..., 0:1, :]).to(torch.float32)
    for k in range(1, A.shape[-1]):
        acc = (a[..., :, k:k + 1] * b[..., k:k + 1, :]
               + acc.to(torch.float64)).to(torch.float32)
    return acc[..., 0] if vec else acc


def _rows_times(x: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """x (..., N, 3) @ M (..., 3, 3) as three products summed in order,
    each an elementwise op: the card and the CPU round every pixel's
    coordinates alike (a matmul's summation order is the library's).
    XLA's CPU dot of a pixel grid sums in an order of its own; this one
    leaves the rectified images nearer the JAX package's than ``_mm``'s
    order does."""
    M = M[..., None, :, :]
    return (x[..., 0:1] * M[..., 0, :] + x[..., 1:2] * M[..., 1, :]
            + x[..., 2:3] * M[..., 2, :])


def _camera_center2(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Optical center of camera 2 in the camera-1 frame, -R^T t."""
    return -_mm(R.transpose(-1, -2), t)


def _rectifying_rotation(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Common rotation with x-axis along the baseline (Fusiello step).

    World frame = camera 1. Rows: r1 = baseline direction, r2 = z_old x r1,
    r3 = r1 x r2.
    """
    r1 = geo.normalize_vec(_camera_center2(R, t))
    # keep rectified x pointing roughly along old +x so images stay upright
    r1 = r1 * torch.where(r1[..., 0:1] < 0, -1.0, 1.0)
    z_old = torch.tensor([0.0, 0.0, 1.0], dtype=R.dtype, device=R.device)
    r2 = geo.normalize_vec(torch.linalg.cross(z_old.expand_as(r1), r1))
    r3 = torch.linalg.cross(r1, r2)
    return torch.stack([r1, r2, r3], dim=-2)


def _projections(Kn1, Kn2, Rn, c2):
    """P1 = Kn1 [Rn | 0], P2 = Kn2 [Rn | -Rn c2]."""
    P1 = _mm(Kn1, torch.cat([Rn, torch.zeros_like(Rn[:, :1])], dim=1))
    P2 = _mm(Kn2, torch.cat([Rn, -_mm(Rn, c2)[:, None]], dim=1))
    return P1, P2


def rectify_fusiello(
    K1: torch.Tensor, K2: torch.Tensor, R: torch.Tensor, t: torch.Tensor
) -> Rectification:
    """Fusiello-Trucco-Verri rectification (pose_helper.cpp:1459).

    New shared intrinsics = mean of the inputs with zero skew (the
    reference's choice); both cameras get the common baseline-aligned
    rotation.
    """
    Rn = _rectifying_rotation(R, t)
    Kn = 0.5 * (K1 + K2)
    Kn[0, 1] = 0.0
    c2 = _camera_center2(R, t)
    baseline = torch.linalg.norm(c2)
    P1, P2 = _projections(Kn, Kn, Rn, c2)
    Q = torch.zeros((4, 4), dtype=R.dtype, device=R.device)
    Q[0, 0] = 1.0
    Q[1, 1] = 1.0
    Q[0, 3] = -Kn[0, 2]
    Q[1, 3] = -Kn[1, 2]
    Q[2, 3] = Kn[0, 0]
    Q[3, 2] = -1.0 / -baseline
    return Rectification(
        R1=Rn, R2=_mm(Rn, R.transpose(-1, -2)), K_new1=Kn, K_new2=Kn, P1=P1,
        P2=P2, Q=Q, baseline=baseline,
    )


def estimate_vergence(
    R: torch.Tensor,
    RR1: torch.Tensor,
    RR2: torch.Tensor,
    PR1: torch.Tensor,
    PR2: torch.Tensor,
) -> torch.Tensor:
    """Vergence (correspondence-search start shift, in pixels) of a
    rectified rig (estimateVergence, pose_helper.cpp:2505-2535).

    R: cam1->cam2 rotation; RR1/RR2: rectifying rotations; PR1/PR2:
    (3, 4) rectified projection matrices (camera 1 centred at the
    origin). Projects camera-2's viewing direction (the last row of R)
    through both rectified cameras; the x-disparity of those projections
    is the epipolar search offset. Returns ceil(1.1 * vergence) as an
    int32 scalar (0 when the rig has no vergence — parallel axes).
    """
    a = R[2, :]  # cam2 z-axis expressed in cam1 coords
    ar1 = _mm(PR1[:, :3], _mm(RR1, a))
    ar2 = _mm(PR2[:, :3], RR2[:, 2])
    ar1 = ar1 / torch.where(ar1[2].abs() > 1e-12, ar1[2], 1.0)
    ar2 = ar2 / torch.where(ar2[2].abs() > 1e-12, ar2[2], 1.0)
    vergence = ar1[0] - ar2[0]
    out = torch.ceil(1.1 * vergence)
    return torch.where(vergence.abs() < 1e-6, 0.0, out).to(torch.int32)


def stereo_rectify(
    K1: torch.Tensor,
    K2: torch.Tensor,
    R: torch.Tensor,
    t: torch.Tensor,
    img_hw: tuple[int, int],
    focal_scale: torch.Tensor | float = 1.0,
    zero_disparity: bool = True,
) -> Rectification:
    """OpenCV-compatible rectification (stereoRectify2, pose_helper.cpp:1900).

    Same geometric construction as Fusiello; the new focal length is the
    mean focal scaled by ``focal_scale`` (the reference's
    estimateOptimalFocalScale result) and the principal point is recentred
    so the original image centers stay centred after rotation.

    zero_disparity=True shares the horizontal principal point
    (CALIB_ZERO_DISPARITY: a point at infinity has zero disparity);
    False keeps per-camera cx (the reference engine's convention, where
    the infinite-depth disparity offset is reported by estimate_vergence
    as the correspondence-search start shift).
    """
    H, W = img_hw
    Rn = _rectifying_rotation(R, t)
    c2 = _camera_center2(R, t)
    baseline = torch.linalg.norm(c2)

    f = 0.25 * (K1[0, 0] + K1[1, 1] + K2[0, 0] + K2[1, 1]) * focal_scale

    R1 = Rn
    R2 = _mm(Rn, R.transpose(-1, -2))

    # recentre: map each original center through its rectifying rotation
    def center_after(Kc, Rrect):
        c = torch.tensor([0.5 * (W - 1), 0.5 * (H - 1), 1.0], dtype=R.dtype,
                         device=R.device)
        r = _mm(Rrect, _mm(_inv3(Kc), c))
        return r[:2] / torch.clamp(r[2], min=1e-9)

    c1n = center_after(K1, R1)
    c2n = center_after(K2, R2)
    # shared vertical center (rows must align), per-camera horizontal
    cy = 0.5 * (H - 1) - f * 0.5 * (c1n[1] + c2n[1])
    cx1 = 0.5 * (W - 1) - f * c1n[0]
    cx2 = 0.5 * (W - 1) - f * c2n[0]
    if zero_disparity:
        # share cx (simple Q form, zero disparity at infinity)
        cx1 = cx2 = 0.5 * (cx1 + cx2)

    def mkK(cxv):
        z = torch.zeros((), dtype=R.dtype, device=R.device)
        one = torch.ones((), dtype=R.dtype, device=R.device)
        return torch.stack([torch.stack([f, z, cxv]),
                            torch.stack([z, f, cy]),
                            torch.stack([z, z, one])])

    Kn1 = mkK(cx1)
    Kn2 = mkK(cx2)
    P1, P2 = _projections(Kn1, Kn2, Rn, c2)

    Tx = -baseline
    Q = torch.zeros((4, 4), dtype=R.dtype, device=R.device)
    Q[0, 0] = 1.0
    Q[1, 1] = 1.0
    Q[0, 3] = -cx1
    Q[1, 3] = -cy
    Q[2, 3] = f
    Q[3, 2] = -1.0 / Tx
    # disparity of a point at infinity (OpenCV Q[3,3] term; zero in the
    # shared-cx convention)
    Q[3, 3] = (cx1 - cx2) / Tx
    return Rectification(
        R1=R1, R2=R2, K_new1=Kn1, K_new2=Kn2, P1=P1, P2=P2, Q=Q,
        baseline=baseline,
    )


def optimal_focal_scale(
    K1: torch.Tensor,
    K2: torch.Tensor,
    R: torch.Tensor,
    t: torch.Tensor,
    dist1: torch.Tensor,
    dist2: torch.Tensor,
    img_hw: tuple[int, int],
    n_candidates: int = 33,
) -> torch.Tensor:
    """Largest focal scale whose rectified view stays inside both sources.

    Reference: estimateOptimalFocalScale (pose_helper.cpp:2561) searches a
    scale for the new camera matrix; here a fixed grid of candidate scales
    is scored in one batch (all remap grids computed together) and the
    best in-bounds fraction wins — static shapes, no line search. The
    grids are the JAX package's f32 ``linspace`` values to the bit, so
    that the 99% in-bounds test picks the same scale.
    """
    H, W = img_hw
    dt, dev = K1.dtype, K1.device
    scales = torch.from_numpy(_linspace_f32(0.5, 2.0, n_candidates)).to(
        device=dev, dtype=dt)

    # border sample points of the output image (fixed ring of 64 points)
    n_b = 16
    xs = _linspace_f32(0.0, W - 1.0, n_b)
    ys = _linspace_f32(0.0, H - 1.0, n_b)
    border = np.concatenate([
        np.stack([xs, np.zeros_like(xs)], axis=1),
        np.stack([xs, np.full_like(xs, H - 1.0)], axis=1),
        np.stack([np.zeros_like(ys), ys], axis=1),
        np.stack([np.full_like(ys, W - 1.0), ys], axis=1),
    ])
    border = torch.from_numpy(border).to(device=dev, dtype=dt)

    rect = stereo_rectify(K1, K2, R, t, img_hw, 1.0)
    # every candidate's K_new1 with its focal set, (S, 3, 3)
    f = 0.25 * (K1[0, 0] + K1[1, 1] + K2[0, 0] + K2[1, 1]) * scales
    Kn = rect.K_new1.expand(n_candidates, 3, 3).clone()
    Kn[:, 0, 0] = f
    Kn[:, 1, 1] = f

    def frac_inside(Kc, distc, Rrect):
        src = rectify_source_coords(border, Kc, distc, Rrect, Kn)
        ok = ((src[..., 0] >= 0) & (src[..., 0] <= W - 1)
              & (src[..., 1] >= 0) & (src[..., 1] <= H - 1))
        return torch.mean(ok.to(dt), dim=-1)

    fracs = torch.minimum(frac_inside(K1, dist1, rect.R1),
                          frac_inside(K2, dist2, rect.R2))
    # prefer the largest scale (tightest FOV crop) that keeps >=99% inside;
    # fall back to the best-covered scale
    good = fracs >= 0.99
    best_covered = scales[torch.argmax(fracs)]
    largest_good = torch.max(torch.where(good, scales, -torch.inf))
    return torch.where(torch.any(good), largest_good, best_covered)


def rectify_source_coords(out_px, K, dist, Rrect, K_new):
    """Output rectified pixels -> source image pixels (one camera).

    out_px: (N, 2); K_new (..., 3, 3) gives (..., N, 2). Inverse mapping
    used by initUndistortRectifyMap: ray = Rrect^T @ K_new^-1 @ p,
    normalize to z = 1, apply forward distortion, then the original K.
    """
    h = geo.to_homogeneous(out_px)
    # rows: Rrect^T Kn^-1 p
    rays = _rows_times(_rows_times(h, _inv3(K_new).transpose(-1, -2)), Rrect)
    z = rays[..., 2:]
    xn = rays[..., :2] / torch.clamp(z.abs(), min=1e-9) * torch.sign(z)
    xd = geo.distort_oulu(xn, dist)
    return geo.cam_to_img(xd, K)


def rectified_image(
    img: torch.Tensor,  # (H, W) grayscale
    K: torch.Tensor,
    dist: torch.Tensor,
    Rrect: torch.Tensor,
    K_new: torch.Tensor,
    out_hw: tuple[int, int],
) -> torch.Tensor:
    """Undistort + rectify remap with bilinear sampling.

    Reference: GetRectifiedImages (pose_helper.cpp:2775) via
    cv::initUndistortRectifyMap + remap; here the sampling grid and the
    gather run over every output pixel at once.
    """
    Ho, Wo = out_hw
    H, W = img.shape
    yy, xx = torch.meshgrid(
        torch.arange(Ho, dtype=img.dtype, device=img.device),
        torch.arange(Wo, dtype=img.dtype, device=img.device), indexing="ij")
    out_px = torch.stack([xx.reshape(-1), yy.reshape(-1)], dim=1)
    src = rectify_source_coords(out_px, K, dist, Rrect, K_new)
    sx = src[:, 0]
    sy = src[:, 1]
    # a non-finite source (a ray at z = 0 through the distortion) lies
    # outside and reads 0; keep its gather index in range
    sxf = torch.where(torch.isfinite(sx), sx, 0.0)
    syf = torch.where(torch.isfinite(sy), sy, 0.0)
    x0 = torch.clamp(torch.floor(sxf), 0, W - 2).to(torch.int64)
    y0 = torch.clamp(torch.floor(syf), 0, H - 2).to(torch.int64)
    fx = torch.clamp(sx - x0, 0.0, 1.0)
    fy = torch.clamp(sy - y0, 0.0, 1.0)
    v00 = img[y0, x0]
    v01 = img[y0, x0 + 1]
    v10 = img[y0 + 1, x0]
    v11 = img[y0 + 1, x0 + 1]
    val = (
        v00 * (1 - fx) * (1 - fy)
        + v01 * fx * (1 - fy)
        + v10 * (1 - fx) * fy
        + v11 * fx * fy
    )
    # half-pixel tolerance: borderline float error must not blank edge rows
    inside = (sx >= -0.5) & (sx <= W - 0.5) & (sy >= -0.5) & (sy <= H - 0.5)
    return torch.where(inside, val, 0.0).reshape(Ho, Wo)


def get_rectification_parameters(
    K1, K2, R, t, dist1, dist2, img_hw, use_fusiello: bool = False
) -> Rectification:
    """Top-level dispatch (getRectificationParameters pose_helper.cpp:1366):
    optimal focal scale + the chosen rectification construction."""
    if use_fusiello:
        return rectify_fusiello(K1, K2, R, t)
    scale = optimal_focal_scale(K1, K2, R, t, dist1, dist2, img_hw)
    return stereo_rectify(K1, K2, R, t, img_hw, scale)
