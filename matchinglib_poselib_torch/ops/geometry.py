"""Epipolar / camera geometry (port of ``ops/geometry.py``, main-path subset).

Every function is plain tensor arithmetic over arbitrary leading batch
dims, so the same code serves one pair or a hypothesis batch; variable
point sets carry a mask. Float32 throughout, on the inputs' device.
"""

from __future__ import annotations

import math

import torch

from matchinglib_poselib_torch.ops import smalllinalg


# ---------------------------------------------------------------------------
# basic linear algebra helpers
# ---------------------------------------------------------------------------


def skew(t: torch.Tensor) -> torch.Tensor:
    """Cross-product matrix [t]x for t of shape (..., 3) -> (..., 3, 3)."""
    tx, ty, tz = t[..., 0], t[..., 1], t[..., 2]
    z = torch.zeros_like(tx)
    return torch.stack(
        [
            torch.stack([z, -tz, ty], dim=-1),
            torch.stack([tz, z, -tx], dim=-1),
            torch.stack([-ty, tx, z], dim=-1),
        ],
        dim=-2,
    )


def essential_from_rt(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """E = [t]x R (reference: pose_helper.cpp:785 getEfromRT)."""
    return skew(t) @ R


def floor_mod(x: torch.Tensor, m: float) -> torch.Tensor:
    """``jnp.mod`` for floats: fmod, shifted by m where the signs differ.

    ``torch.remainder`` computes x - m * floor(x / m), which rounds
    differently; this keeps the JAX package's arithmetic.
    """
    r = torch.fmod(x, m)
    return torch.where((r != 0) & ((r < 0) != (m < 0)), r + m, r)


def normalize_vec(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=eps)


def to_homogeneous(x: torch.Tensor) -> torch.Tensor:
    """(..., N, 2) -> (..., N, 3) with trailing ones."""
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def img_to_cam(pts: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Pixel -> normalized camera coords (pose_helper.cpp:1100)."""
    fx = K[..., 0, 0][..., None]
    fy = K[..., 1, 1][..., None]
    s = K[..., 0, 1][..., None]
    cx = K[..., 0, 2][..., None]
    cy = K[..., 1, 2][..., None]
    y = (pts[..., 1] - cy) / fy
    x = (pts[..., 0] - cx - s * y) / fx
    return torch.stack([x, y], dim=-1)


def undistort_oulu(
    pts: torch.Tensor, dist: torch.Tensor, iterations: int = 20
) -> torch.Tensor:
    """Fixed-iteration Oulu-model undistortion of normalized coords.

    Reference: pose_helper.cpp:1169 Remove_LensDist -> :1241 LensDist_Oulu.
    pts: (..., N, 2); dist: (..., 5) [k1, k2, p1, p2, k3].
    """
    k1 = dist[..., 0][..., None]
    k2 = dist[..., 1][..., None]
    p1 = dist[..., 2][..., None]
    p2 = dist[..., 3][..., None]
    k3 = dist[..., 4][..., None]
    xy = pts
    for _ in range(iterations):
        x, y = xy[..., 0], xy[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        xu = (pts[..., 0] - dx) / radial
        yu = (pts[..., 1] - dy) / radial
        xy = torch.stack([xu, yu], dim=-1)
    return xy


def distort_oulu(pts: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """Forward Oulu distortion of normalized coords (inverse of
    ``undistort_oulu``). pts: (..., 2); dist: (..., 5)."""
    k1, k2, p1, p2, k3 = (dist[..., i] for i in range(5))
    x, y = pts[..., 0], pts[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


# ---------------------------------------------------------------------------
# epipolar residuals
# ---------------------------------------------------------------------------


def epipolar_products(E: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor):
    """Shared terms: x2^T E x1, E x1, E^T x2 -> (..., N), (..., N, 3) x2."""
    h1 = to_homogeneous(x1)
    h2 = to_homogeneous(x2)
    Ex1 = h1 @ E.transpose(-1, -2)
    Etx2 = h2 @ E
    num = torch.sum(h2 * Ex1, dim=-1)
    return num, Ex1, Etx2


def sampson_error(
    E: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor
) -> torch.Tensor:
    """Squared Sampson distance per correspondence (..., N).

    A vanishing denominator (degenerate model) scores as a gross error.
    """
    num, Ex1, Etx2 = epipolar_products(E, x1, x2)
    denom = (
        Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2
        + Etx2[..., 1] ** 2
    )
    return torch.where(
        denom > 1e-12, (num * num) / torch.clamp(denom, min=1e-12), 1e9
    )


# ---------------------------------------------------------------------------
# essential-matrix manifold
# ---------------------------------------------------------------------------


def closest_essential(E: torch.Tensor) -> torch.Tensor:
    """Project onto the essential manifold: sv -> (s, s, 0), s = (s1+s2)/2.

    Reference: pose_helper.cpp:152 getClosestE, via the closed-form
    Jacobi svd3x3.
    """
    U, s, Vt = smalllinalg.svd3x3(E)
    m = 0.5 * (s[..., 0] + s[..., 1])
    s_new = torch.stack([m, m, torch.zeros_like(m)], dim=-1)
    return (U * s_new[..., None, :]) @ Vt


def closest_essential_fast(E: torch.Tensor) -> torch.Tensor:
    """Essential-manifold projection via a quadratic matrix polynomial.

    Same projection as closest_essential, without an SVD: E g(E^T E) with
    the quadratic g interpolating g(l1) = m/s1, g(l2) = m/s2, g(l3) = 0 on
    the Cardano eigenvalues of E^T E (Newton form, confluent-safe). A
    rank-1 input gives NaN, exactly as in the JAX package.
    """
    dtype, dev = E.dtype, E.device
    eps = 1e-20
    M = E.transpose(-1, -2) @ E
    eye = torch.eye(3, dtype=dtype, device=dev)
    q = (M[..., 0, 0] + M[..., 1, 1] + M[..., 2, 2]) / 3.0
    B = M - q[..., None, None] * eye
    p2 = torch.sum(B * B, dim=(-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=1e-38))
    Bn = B / p[..., None, None]
    detBn = (
        Bn[..., 0, 0] * (Bn[..., 1, 1] * Bn[..., 2, 2]
                         - Bn[..., 1, 2] * Bn[..., 2, 1])
        - Bn[..., 0, 1] * (Bn[..., 1, 0] * Bn[..., 2, 2]
                           - Bn[..., 1, 2] * Bn[..., 2, 0])
        + Bn[..., 0, 2] * (Bn[..., 1, 0] * Bn[..., 2, 1]
                           - Bn[..., 1, 1] * Bn[..., 2, 0])
    )
    phi = torch.arccos(torch.clamp(detBn / 2.0, -1.0, 1.0)) / 3.0
    l1 = q + 2.0 * p * torch.cos(phi)
    l3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    l2 = 3.0 * q - l1 - l3
    l1 = torch.clamp(l1, min=0.0)
    l2 = torch.clamp(l2, min=0.0)
    l3 = torch.clamp(l3, min=0.0)
    s1 = torch.sqrt(l1)
    s2 = torch.sqrt(l2)
    m = 0.5 * (s1 + s2)
    h1 = m / torch.clamp(s1, min=eps)
    h2 = m / torch.clamp(s2, min=eps)
    d12 = l1 - l2
    dd12_generic = (h1 - h2) / torch.where(torch.abs(d12) > eps, d12, 1.0)
    dd12_confl = -m / torch.clamp(
        2.0 * l1 * torch.clamp(s1, min=eps), min=eps
    )
    near = torch.abs(d12) <= 1e-6 * torch.clamp(l1, min=eps)
    dd12 = torch.where(near, dd12_confl, dd12_generic)
    d23 = torch.clamp(l2 - l3, min=eps)
    dd23 = h2 / d23
    dd123 = (dd12 - dd23) / torch.clamp(l1 - l3, min=eps)
    A1 = M - l1[..., None, None] * eye
    A2 = M - l2[..., None, None] * eye
    gM = (
        h1[..., None, None] * eye
        + dd12[..., None, None] * A1
        + dd123[..., None, None] * (A1 @ A2)
    )
    return E @ gM


# ---------------------------------------------------------------------------
# rotations / pose comparison
# ---------------------------------------------------------------------------


def rot_from_quat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (w, x, y, z) -> rotation matrix."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n = w * w + x * x + y * y + z * z
    s = 2.0 / torch.clamp(n, min=1e-12)
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return torch.stack(
        [
            torch.stack([1.0 - (yy + zz), xy - wz, xz + wy], dim=-1),
            torch.stack([xy + wz, 1.0 - (xx + zz), yz - wx], dim=-1),
            torch.stack([xz - wy, yz + wx, 1.0 - (xx + yy)], dim=-1),
        ],
        dim=-2,
    )


def rotation_angle(R: torch.Tensor) -> torch.Tensor:
    """Rotation angle (radians) of R."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    return torch.arccos(torch.clamp(0.5 * (tr - 1.0), -1.0, 1.0))


def compare_poses(R1, t1, R2, t2):
    """Pose difference metrics (pose_helper.cpp:1296 compareRTs).

    Returns (rot_diff_deg, t_ang_diff_deg, t_dist).
    """
    dR = R1.transpose(-1, -2) @ R2
    rdiff = rotation_angle(dR) * (180.0 / math.pi)
    t1n = normalize_vec(t1)
    t2n = normalize_vec(t2)
    ca = torch.clamp(torch.sum(t1n * t2n, dim=-1), -1.0, 1.0)
    tang = torch.arccos(ca) * (180.0 / math.pi)
    tdist = torch.linalg.norm(t1n - t2n, dim=-1)
    return rdiff, tang, tdist


# ---------------------------------------------------------------------------
# robust statistics (masked, fixed-shape)
# ---------------------------------------------------------------------------


def masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median over the masked entries of the last axis (0 when empty)."""
    m = mask.to(torch.bool)
    big = torch.finfo(x.dtype).max
    xs = torch.sort(torch.where(m, x, big), dim=-1).values
    n = torch.sum(m, dim=-1).to(torch.int64)
    last = x.shape[-1] - 1
    hi = torch.clamp((n - 1) // 2 + (n - 1) % 2, 0, last)
    lo = torch.clamp((n - 1) // 2, 0, last)
    vlo = torch.gather(xs, -1, lo[..., None])[..., 0]
    vhi = torch.gather(xs, -1, hi[..., None])[..., 0]
    med = 0.5 * (vlo + vhi)
    return torch.where(n > 0, med, torch.zeros_like(med))


def masked_stats(x: torch.Tensor, mask: torch.Tensor):
    """(median, mean, std, MAD) over the masked entries of the last axis
    (the reference's statVals, pose_helper.cpp:358 getStatsfromVec)."""
    m = mask.to(x.dtype)
    n = torch.clamp(torch.sum(m, dim=-1), min=1.0)
    mean = torch.sum(x * m, dim=-1) / n
    var = torch.sum(m * (x - mean[..., None]) ** 2, dim=-1) / n
    med = masked_median(x, mask)
    mad = masked_median(torch.abs(x - med[..., None]), mask)
    return med, mean, torch.sqrt(var), mad


# ---------------------------------------------------------------------------
# triangulation + pose recovery
# ---------------------------------------------------------------------------


def _solve3_cramer(A, b):
    """Batched 3x3 solve via the adjugate (closed form)."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a10, a11, a12 = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    a20, a21, a22 = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a12 * a20 - a10 * a22
    c02 = a10 * a21 - a11 * a20
    det = a00 * c00 + a01 * c01 + a02 * c02
    c10 = a02 * a21 - a01 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a01 * a20 - a00 * a21
    c20 = a01 * a12 - a02 * a11
    c21 = a02 * a10 - a00 * a12
    c22 = a00 * a11 - a01 * a10
    det = torch.where(torch.abs(det) > 1e-20, det, 1e-20)
    x0 = (c00 * b[..., 0] + c10 * b[..., 1] + c20 * b[..., 2]) / det
    x1 = (c01 * b[..., 0] + c11 * b[..., 1] + c21 * b[..., 2]) / det
    x2 = (c02 * b[..., 0] + c12 * b[..., 1] + c22 * b[..., 2]) / det
    return torch.stack([x0, x1, x2], dim=-1)


def triangulate_linear(R, t, x1, x2):
    """Two-view linear (DLT) triangulation in the camera-1 frame.

    Cameras P1 = [I|0], P2 = [R|t]; x1, x2 normalized coords (..., N, 2).
    Inhomogeneous 4x3 DLT (w = 1) via 3x3 normal equations and a Cramer
    solve. Returns (..., N, 3).
    """
    shape = x1.shape[:-1]
    dt, dev = R.dtype, R.device
    P1 = torch.cat(
        [torch.eye(3, dtype=dt, device=dev),
         torch.zeros((3, 1), dtype=dt, device=dev)], dim=1,
    ).expand(R.shape[:-2] + (3, 4))
    P2 = torch.cat([R, t[..., None]], dim=-1)

    def rows(P, x):
        Pb = P[..., None, :, :]
        r0 = x[..., 0:1] * Pb[..., 2, :] - Pb[..., 0, :]
        r1 = x[..., 1:2] * Pb[..., 2, :] - Pb[..., 1, :]
        return r0, r1

    a0, a1 = rows(P1, x1)
    a2, a3 = rows(P2, x2)
    A4 = torch.stack(torch.broadcast_tensors(a0, a1, a2, a3), dim=-2)
    Am = A4[..., :3]
    bv = -A4[..., 3]
    AtA = Am.transpose(-1, -2) @ Am
    Atb = torch.einsum("...ij,...i->...j", Am, bv)
    pts = _solve3_cramer(AtA, Atb)
    return pts.reshape(shape + (3,))


def decompose_essential(E: torch.Tensor):
    """E -> (R1, R2, t) candidates with det = +1 and unit t."""
    U, _, Vt = smalllinalg.svd3x3(E)
    dU = torch.linalg.det(U)
    dV = torch.linalg.det(Vt)
    U = U * dU[..., None, None]
    Vt = Vt * dV[..., None, None]
    W = torch.tensor(
        [[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
        dtype=E.dtype, device=E.device,
    )
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[..., :, 2]
    return R1, R2, t


def cheirality_counts(R, t, x1, x2, mask, dist_thresh: float = 50.0):
    """Count points in front of both cameras with depth < dist_thresh
    (five-point.cpp:150-250 recoverPose vote)."""
    X = triangulate_linear(R, t, x1, x2)
    z1 = X[..., 2]
    X2 = X @ R.transpose(-1, -2) + t[..., None, :]
    z2 = X2[..., 2]
    ok = (z1 > 0) & (z2 > 0) & (z1 < dist_thresh) & (z2 < dist_thresh)
    ok = ok & mask.to(torch.bool)
    return torch.sum(ok, dim=-1), X, ok


def topk_stable(x: torch.Tensor, k: int):
    """Top-k along the last axis with ties to the lowest index.

    ``lax.top_k`` semantics; ``torch.topk`` leaves the order of ties
    unspecified, so a stable descending sort takes its place.
    """
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def spread_select(score: torch.Tensor, k: int) -> torch.Tensor:
    """Top-k indices of ``score`` along its last axis with a spatially
    spread tie-break (a per-index Knuth hash below half the smallest score
    step)."""
    n = score.shape[-1]
    h = (torch.arange(n, dtype=torch.int64, device=score.device)
         * 2654435761) % 4294967296
    tie = h.to(score.dtype) * (0.4 / 4294967296.0)
    return topk_stable(score + tie, k)[1]


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows `idx` of x along its point axis, per leading (pair) index:
    x (..., N) or (..., N, C), idx (..., K) -> (..., K) or (..., K, C)."""
    if x.ndim == idx.ndim:
        return torch.gather(x, -1, idx)
    return torch.take_along_dim(x, idx[..., None], dim=-2)


def recover_pose(E, x1, x2, mask, dist_thresh: float = 50.0,
                 vote_points: int | None = None):
    """Cheirality-voted pose from E (five-point.cpp:150 recoverPose).

    E (..., 3, 3), x1, x2 (..., N, 2), mask (..., N), with an optional
    leading pair axis. Returns (R, t, X, good_mask, votes). vote_points:
    when set and smaller than N, the 4-fold vote runs on a spread
    selection of that many points per pair and only the winner is
    triangulated at full N.
    """
    R1, R2, t = decompose_essential(E)
    cands_R = torch.stack([R1, R1, R2, R2], dim=-3)
    cands_t = torch.stack([t, -t, t, -t], dim=-2)

    def take(a, idx):
        ix = idx.reshape(idx.shape + (1,) * (a.ndim - idx.ndim))
        ix = ix.expand(idx.shape + (1,) + a.shape[idx.ndim + 1:])
        return torch.gather(a, idx.ndim, ix).squeeze(idx.ndim)

    if vote_points is not None and vote_points < x1.shape[-2]:
        sel = spread_select(mask.to(x1.dtype), vote_points)
        x1v, x2v, mv = take_rows(x1, sel), take_rows(x2, sel), take_rows(
            mask, sel)
        four = cands_R.shape[:-2]
        votes_s, _, _ = cheirality_counts(
            cands_R, cands_t,
            x1v[..., None, :, :].expand(four + x1v.shape[-2:]),
            x2v[..., None, :, :].expand(four + x2v.shape[-2:]),
            mv[..., None, :].expand(four + mv.shape[-1:]), dist_thresh,
        )
        best = torch.argmax(votes_s, dim=-1)
        R = take(cands_R, best)
        tt = take(cands_t, best)
        nv, Xw, okw = cheirality_counts(R, tt, x1, x2, mask, dist_thresh)
        return R, tt, Xw, okw, nv
    x1b = x1[..., None, :, :].expand(cands_R.shape[:-2] + x1.shape[-2:])
    x2b = x2[..., None, :, :].expand(cands_R.shape[:-2] + x2.shape[-2:])
    maskb = mask[..., None, :].expand(cands_R.shape[:-2] + mask.shape[-1:])
    votes, X, ok = cheirality_counts(cands_R, cands_t, x1b, x2b, maskb,
                                     dist_thresh)
    best = torch.argmax(votes, dim=-1)
    return (take(cands_R, best), take(cands_t, best), take(X, best),
            take(ok, best), take(votes, best))


# ---------------------------------------------------------------------------
# Hartley normalization
# ---------------------------------------------------------------------------


def normalize_points(x: torch.Tensor, mask: torch.Tensor):
    """Shift to centroid, scale mean distance to sqrt(2). Returns (xn, T)."""
    m = mask.to(x.dtype)
    n = torch.clamp(torch.sum(m, dim=-1), min=1.0)
    mean = torch.sum(x * m[..., None], dim=-2) / n[..., None]
    d = torch.linalg.norm(x - mean[..., None, :], dim=-1)
    scale = math.sqrt(2.0) / torch.clamp(torch.sum(d * m, dim=-1) / n,
                                         min=1e-12)
    xn = (x - mean[..., None, :]) * scale[..., None, None]
    z = torch.zeros_like(scale)
    one = torch.ones_like(scale)
    T = torch.stack(
        [
            torch.stack([scale, z, -scale * mean[..., 0]], dim=-1),
            torch.stack([z, scale, -scale * mean[..., 1]], dim=-1),
            torch.stack([z, z, one], dim=-1),
        ],
        dim=-2,
    )
    return xn, T
