"""Pose from multi-plane scenes via homography alignment, Halign (port of
``ops/homography_pose.py``).

- ``estimate_multiple_homographies`` == estimateMultHomographys
  (pose_homography.cpp:291): peel planes one after another, each a robust
  homography fit on the correspondences no earlier plane claimed.
- ``decompose_homography`` == Longuet_Higgins_Solution
  (HomographyAlignment.cpp): the four Faugeras (R, t, n) candidates of a
  calibrated homography.
- ``estimate_pose_halign`` == estimatePoseHomographies
  (pose_homography.cpp:127), with the JAX package's candidate scoring in
  place of the reference's joint alignment: every candidate of every plane
  is scored against all correspondences (MSAC on the epipolar error, a
  cheirality gate) and the best wins; the reference's error codes -1..-4
  say when the scene is not plane-dominated.

Fixed shapes: ``max_planes`` peeling rounds, invalid planes masked out.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from matchinglib_poselib_torch.config import HalignConfig, RobustConfig
from matchinglib_poselib_torch.ops import geometry as geo
from matchinglib_poselib_torch.ops import robust, smalllinalg, solvers


class HomographyDecomposition(NamedTuple):
    R: torch.Tensor  # (..., 4, 3, 3)
    t: torch.Tensor  # (..., 4, 3) unit (zero for a pure rotation)
    n: torch.Tensor  # (..., 4, 3) plane normal in camera 1
    valid: torch.Tensor  # (..., 4) bool


class HalignResult(NamedTuple):
    # each field carries the inputs' pair axis, if any, in front
    R: torch.Tensor  # (3, 3) best pose
    t: torch.Tensor  # (3,) unit translation
    E: torch.Tensor  # (3, 3) essential matrix of the best pose
    n: torch.Tensor  # (3,) plane normal of the winning candidate
    inlier_mask: torch.Tensor  # (N,) epipolar inliers of the best pose
    n_inliers: torch.Tensor
    homographies: torch.Tensor  # (max_planes, 3, 3) (normalized coords)
    plane_masks: torch.Tensor  # (max_planes, N) inliers per plane
    plane_valid: torch.Tensor  # (max_planes,) plane extraction succeeded
    n_planes: torch.Tensor  # number of valid planes
    is_rotation_only: torch.Tensor  # best H is a pure rotation
    # estimatePoseHomographies' return value (pose_homography.cpp:120-266):
    # 0 ok, -1 no homography found, -2 sum of plane strengths too low,
    # -3 no candidate passed scoring / cheirality, -4 pose not finite.
    # On failure the caller falls back to the robust-E path.
    error_code: torch.Tensor  # int32
    # (max_planes,) th n_inl / (actual_th n_corrs)
    plane_strengths: torch.Tensor


def _det3(A: torch.Tensor) -> torch.Tensor:
    return (A[..., 0, 0] * (A[..., 1, 1] * A[..., 2, 2]
                            - A[..., 1, 2] * A[..., 2, 1])
            - A[..., 0, 1] * (A[..., 1, 0] * A[..., 2, 2]
                              - A[..., 1, 2] * A[..., 2, 0])
            + A[..., 0, 2] * (A[..., 1, 0] * A[..., 2, 1]
                              - A[..., 1, 1] * A[..., 2, 0]))


def decompose_homography(H: torch.Tensor) -> HomographyDecomposition:
    """Faugeras SVD decomposition of calibrated homographies H (..., 3, 3),
    x2 ~ H x1 with H = R + t n^T / d: the four sign combinations (e1, e3)
    in the order (1, 1), (1, -1), (-1, 1), (-1, -1). The SVD's sign
    convention may differ from another SVD's, which permutes the four;
    the set is the same. Candidates with a normal of negative z stay: the
    caller's cheirality vote sorts them out."""
    U, S, Vt = smalllinalg.svd3x3(H)
    d2 = torch.clamp(S[..., 1], min=1e-12)
    d1 = S[..., 0] / d2
    d3 = S[..., 2] / d2
    s = _det3(U) * _det3(Vt)
    denom = torch.clamp(d1 * d1 - d3 * d3, min=1e-12)
    aux1 = torch.sqrt(torch.clamp((d1 * d1 - 1.0) / denom, min=0.0))
    aux3 = torch.sqrt(torch.clamp((1.0 - d3 * d3) / denom, min=0.0))
    # Faugeras-Lustman with d2 = 1: sin(theta) = (d1 - d3) x1 x3,
    # cos(theta) = (1 + d1 d3) / (d1 + d3)
    sin_t = (d1 - d3) * aux1 * aux3
    cos_t = (1.0 + d1 * d3) / torch.clamp(d1 + d3, min=1e-12)
    z = torch.zeros_like(sin_t)
    o = torch.ones_like(sin_t)
    Rs, ts, ns = [], [], []
    for e1, e3 in ((1.0, 1.0), (1.0, -1.0), (-1.0, 1.0), (-1.0, -1.0)):
        st = e1 * e3 * sin_t
        Rp = torch.stack([
            torch.stack([cos_t, z, -st], dim=-1),
            torch.stack([z, o, z], dim=-1),
            torch.stack([st, z, cos_t], dim=-1),
        ], dim=-2)
        npr = torch.stack([e1 * aux1, z, e3 * aux3], dim=-1)
        tp = (d1 - d3)[..., None] * torch.stack([e1 * aux1, z, -e3 * aux3],
                                                dim=-1)
        Rs.append(s[..., None, None] * (U @ Rp @ Vt))
        ts.append((U @ tp[..., None])[..., 0])
        ns.append((Vt.transpose(-1, -2) @ npr[..., None])[..., 0])
    Rs = torch.stack(Rs, dim=-3)
    ts = torch.stack(ts, dim=-2)
    ns = torch.stack(ns, dim=-2)
    ts = ts / torch.clamp(torch.linalg.norm(ts, dim=-1, keepdim=True),
                          min=1e-12)
    # pure rotation (plane at infinity / no parallax): d1 ~ d3 ~ 1
    rot_only = ((d1 - d3) < 1e-4)[..., None]
    valid = (torch.isfinite(Rs).all(dim=-1).all(dim=-1)
             & torch.isfinite(ts).all(dim=-1))
    return HomographyDecomposition(
        R=Rs, t=torch.where(rot_only[..., None], 0.0, ts), n=ns, valid=valid)


def _pick(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a[..., idx, ...] along the axis after idx's: a (*idx.shape, C, ...),
    idx (...) -> (*idx.shape, ...)."""
    d = idx.ndim
    ix = idx.reshape(idx.shape + (1,) * (a.ndim - d))
    return torch.take_along_dim(a, ix, dim=d).squeeze(d)


def estimate_multiple_homographies(
    x1: torch.Tensor,
    x2: torch.Tensor,
    mask: torch.Tensor,
    quality: torch.Tensor | None,
    cfg: HalignConfig,
    robust_cfg: RobustConfig,
    threshold_sq,
    plane_uniforms: torch.Tensor,
):
    """Iterative plane peeling (estimateMultHomographys,
    pose_homography.cpp:291). Returns (H (..., max_planes, 3, 3),
    plane_masks (..., max_planes, N), plane_valid (..., max_planes)).

    Round r fits a homography robustly (at 1.5x the pose threshold, the
    reference's th_mult_base) on the correspondences rounds < r left, re-fits
    it twice on all its inliers (kept only without loss of support), and
    claims its members at the tight 1.0x threshold; fewer than
    ``min_plane_inliers`` members, or too few remaining points, make an
    invalid plane. Takes an optional leading pair axis: x1, x2 (P, N, 2),
    mask and quality (P, N), threshold_sq (P,) or shared. plane_uniforms:
    (..., max_planes, max_batches, B, 4), plane r's sample uniforms (the
    JAX package's r-th ``split`` of the key).
    """
    dt, dev = x1.dtype, x1.device
    batch = x1.shape[:-2]
    fam = robust.homography_family()
    remaining = mask.to(torch.bool)
    th_t = torch.as_tensor(threshold_sq, dtype=dt, device=dev).expand(
        batch)[..., None]
    th_h = 2.25 * th_t
    eye = torch.eye(3, dtype=dt, device=dev)
    Hs, masks, valids = [], [], []
    for r in range(cfg.max_planes):
        res = robust.ransac(fam, x1, x2, remaining, quality, robust_cfg,
                            threshold_sq=th_h[..., 0],
                            uniforms=plane_uniforms[..., r, :, :, :])
        H, inl, n_inl = res.model, res.inlier_mask, res.n_inliers
        # all-inlier DLT re-fits (refineHomography,
        # pose_homography.cpp:825): a minimal 4-point H misses part of its
        # plane, which would split one plane over several rounds
        for _ in range(2):
            H2, ok2 = solvers.solve_homography(x1, x2, mask=inl.to(dt),
                                               pairs=True)
            err2 = solvers.homography_transfer_error(H2, x1, x2)
            inl2 = (err2 < th_h) & remaining
            n2 = torch.sum(inl2, dim=-1)
            better = ok2 & (n2 >= n_inl)
            H = torch.where(better[..., None, None], H2, H)
            inl = torch.where(better[..., None], inl2, inl)
            n_inl = torch.where(better, n2, n_inl)
        err_t = solvers.homography_transfer_error(H, x1, x2)
        inl_t = (err_t < th_t) & remaining
        ok = (torch.sum(inl_t, dim=-1) >= cfg.min_plane_inliers) & (
            torch.sum(remaining, dim=-1) >= fam.sample_size * 2)
        plane_mask = inl_t & ok[..., None]
        Hs.append(torch.where(ok[..., None, None], H, eye))
        masks.append(plane_mask)
        valids.append(ok)
        remaining = remaining & ~plane_mask
    d = len(batch)
    return (torch.stack(Hs, dim=d), torch.stack(masks, dim=d),
            torch.stack(valids, dim=d))


def estimate_pose_halign(
    x1: torch.Tensor,
    x2: torch.Tensor,
    mask: torch.Tensor,
    quality: torch.Tensor | None,
    cfg: HalignConfig,
    robust_cfg: RobustConfig,
    threshold_sq=None,
    *,
    plane_uniforms: torch.Tensor,
) -> HalignResult:
    """Pose for (multi-)planar scenes (estimatePoseHomographies,
    pose_homography.cpp:127). x1, x2: (N, 2) normalized coords; mask:
    validity; quality: PROSAC order of the plane fits; plane_uniforms: see
    ``estimate_multiple_homographies``. Takes an optional leading pair
    axis there, as ``estimate_multiple_homographies`` does; every field
    of the result is then per pair."""
    dt, dev = x1.dtype, x1.device
    batch = x1.shape[:-2]
    if threshold_sq is None:
        threshold_sq = robust_cfg.threshold_px ** 2
    th = torch.as_tensor(threshold_sq, dtype=dt, device=dev).expand(batch)
    Hs, plane_masks, plane_valid = estimate_multiple_homographies(
        x1, x2, mask, quality, cfg, robust_cfg, th, plane_uniforms)
    C = Hs.shape[-3] * 4
    dec = decompose_homography(Hs)  # (..., max_planes, 4, ...)
    Rc = dec.R.reshape(batch + (C, 3, 3))
    tc = dec.t.reshape(batch + (C, 3))
    nc = dec.n.reshape(batch + (C, 3))
    cand_valid = (dec.valid & plane_valid[..., None]).reshape(batch + (C,))

    # every candidate against all correspondences, as one batch
    maskb = mask.to(torch.bool)
    th_c = th[..., None, None]
    has_t = torch.linalg.norm(tc, dim=-1) > 1e-8
    Es = geo.essential_from_rt(Rc, torch.where(has_t[..., None], tc, 1.0))
    x1c, x2c = x1[..., None, :, :], x2[..., None, :, :]
    err_e = geo.sampson_error(Es, x1c, x2c)
    # a rotation-only candidate has no E: score R as the homography
    # x2 ~ R x1 (transfer error, same units)
    err_r = solvers.homography_transfer_error(Rc, x1c, x2c)
    err = torch.where(has_t[..., None], err_e, err_r)
    inls = maskb[..., None, :] & (err < th_c)
    n_epi = torch.sum(inls, dim=-1)
    # MSAC: prefers the more accurate model when inlier counts tie
    msac = torch.sum(torch.where(inls, th_c - err, 0.0), dim=-1)
    n_good, _, _ = geo.cheirality_counts(Rc, tc, x1c.expand(inls.shape + (2,)),
                                         x2c.expand(inls.shape + (2,)), inls)
    cheir_ok = ~has_t | (n_good >= 0.75 * n_epi.to(dt))
    scores = torch.where(cand_valid & cheir_ok & (n_epi > 0), msac, -1.0)
    best = torch.argmax(scores, dim=-1)

    Rb, tb, nb = _pick(Rc, best), _pick(tc, best), _pick(nc, best)
    Eb, inl, score_b = _pick(Es, best), _pick(inls, best), _pick(scores,
                                                                 best)
    n_inl = torch.sum(inl.to(torch.int32), dim=-1)
    rot_only = torch.linalg.norm(tb, dim=-1) < 1e-8
    # rotation only: E undefined, reported as zero with t = 0
    Eb = torch.where(rot_only[..., None, None], 0.0, Eb)

    # failure codes (pose_homography.cpp:200 -1, :243 -2, :246 -3,
    # :266 -4); plane strength th n_inl / (actual_th n_corrs) (:354) with
    # membership at the tight threshold, so th / actual_th = 1
    n_planes = torch.sum(plane_valid.to(torch.int32), dim=-1)
    n_corrs = torch.clamp(torch.sum(maskb.to(dt), dim=-1), min=1.0)
    strengths = torch.sum(plane_masks.to(dt), dim=-1) / n_corrs[..., None]
    strengths = torch.where(plane_valid, strengths, 0.0)
    str_sum = torch.sum(torch.where(strengths > 0.1, strengths, 0.0),
                        dim=-1)
    pose_finite = (torch.isfinite(Rb).all(dim=-1).all(dim=-1)
                   & torch.isfinite(tb).all(dim=-1))
    weak = (str_sum <= 0.5) & cfg.check_plane_strength
    code = torch.where(
        n_planes == 0, -1,
        torch.where(weak, -2,
                    torch.where(score_b < 0.0, -3,
                                torch.where(pose_finite, 0, -4)))
    ).to(torch.int32)
    return HalignResult(
        R=Rb, t=tb, E=Eb, n=nb, inlier_mask=inl, n_inliers=n_inl,
        homographies=Hs, plane_masks=plane_masks, plane_valid=plane_valid,
        n_planes=n_planes, is_rotation_only=rot_only, error_code=code,
        plane_strengths=strengths,
    )
