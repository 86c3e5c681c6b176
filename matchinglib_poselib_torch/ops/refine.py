"""Linear IRLS refinement and the (R, t) Sampson polish (port of
``ops/refine.py``).

- ``refine_essential_linear``: IRLS on a shrinking threshold band with
  Torr / pseudo-Huber weights, the inlier-loss guard and the
  support-guarded manifold projection (pose_linear_refinement.cpp:85-640).
- ``polish_pose_sampson`` / ``polish_pose_iterative``: Levenberg-Marquardt
  over the 5-DOF pose manifold on the robustified signed Sampson error,
  alternated with inlier re-selection.

Fixed-count loops are plain loops; the convergence latches of the JAX
package's ``lax.while_loop``s read their flag on the host once per
iteration (``utils.profiling.HostSyncs``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd

from matchinglib_poselib_torch.config import (
    MinimalSolver,
    RefinementConfig,
    RefineWeights,
)
from matchinglib_poselib_torch.ops import geometry as geo
from matchinglib_poselib_torch.ops import smalllinalg, solvers
from matchinglib_poselib_torch.ops.robust import _inv_sim
from matchinglib_poselib_torch.utils.profiling import HostSyncs


class RefineResult(NamedTuple):
    model: torch.Tensor  # (3, 3) refined essential matrix
    inlier_mask: torch.Tensor  # (N,) bool
    n_inliers: torch.Tensor
    mean_sampson: torch.Tensor  # mean squared Sampson error on inliers


def _weights(E, x1, x2, err_sq, th_sq, kind: RefineWeights):
    """IRLS weights: Torr's epipolar-gradient normalization, times the
    pseudo-Huber factor 1 / (1 + (e/b)^2)^(1/4) for PSEUDO_HUBER
    (weightingEssential.cpp:53-165)."""
    _, Ex1, Etx2 = geo.epipolar_products(E, x1, x2)
    denom = (Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2
             + Etx2[..., 1] ** 2)
    torr = 1.0 / torch.sqrt(torch.clamp(denom, min=1e-12))
    if kind == RefineWeights.TORR:
        return torr
    if kind == RefineWeights.PSEUDO_HUBER:
        e = torch.sqrt(torch.clamp(err_sq, min=1e-20))
        b = torch.sqrt(torch.clamp(th_sq, min=1e-20))
        s = torch.sqrt(1.0 + (e / b) ** 2)
        return torr / torch.sqrt(s)
    return torch.ones_like(torr)


def refine_essential_linear(
    E0: torch.Tensor,
    x1: torch.Tensor,
    x2: torch.Tensor,
    mask: torch.Tensor,
    threshold_sq: torch.Tensor,
    cfg: RefinementConfig = RefinementConfig(),
) -> RefineResult:
    """IRLS refinement of E within a band shrinking from th_multiplier * th
    to th, on a compaction of at most refine_max_points slots; the final
    classification runs on the full set."""
    if cfg.solver == MinimalSolver.KNEIP:
        raise NotImplementedError("the Kneip eigensolver polish is not ported")
    dt, dev = x1.dtype, x1.device
    maskb = mask.to(torch.bool)
    m = cfg.th_multiplier
    iters = cfg.iterations
    step = (m - 1.0) / max(iters, 1)

    x1f, x2f, maskf = x1, x2, maskb
    cap = cfg.refine_max_points
    if cap is not None and cap < x1.shape[0]:
        band_pre = (geo.sampson_error(E0, x1, x2) < m * threshold_sq) & maskb
        score = band_pre.to(dt) + maskb.to(dt)
        sel = geo.spread_select(score, cap)
        x1, x2, maskb = x1[sel], x2[sel], maskb[sel]

    err0 = geo.sampson_error(E0, x1, x2)
    inl0 = (err0 < m * threshold_sq) & maskb
    x1n, T1 = geo.normalize_points(x1, inl0.to(dt))
    x2n, T2 = geo.normalize_points(x2, inl0.to(dt))
    A_rows = solvers.epipolar_rows(x1n, x2n)
    T2t = T2.transpose(-1, -2)

    inl_pre = (err0 < threshold_sq) & maskb
    E, inl, n_inl = E0, inl_pre, torch.sum(inl_pre)
    ns_prev = (_inv_sim(T2).T @ E0 @ _inv_sim(T1)).reshape(9)
    for i in range(iters):
        ip1 = torch.tensor(i + 1.0, dtype=dt, device=dev)
        th_i = (m - ip1 * step) * threshold_sq
        err = geo.sampson_error(E, x1, x2)
        band = (err < th_i) & maskb
        w = _weights(E, x1, x2, err, threshold_sq, cfg.weights) * band.to(dt)
        Aw = A_rows * w[:, None]
        ns = smalllinalg.min_eigvec_spd(Aw.T @ Aw, iterations=2, v0=ns_prev)
        E_new = T2t @ ns.reshape(3, 3) @ T1
        nrm = torch.sqrt(torch.sum(E_new * E_new))
        ok = torch.isfinite(nrm) & (nrm > 1e-12)
        E_new = torch.where(ok, E_new / torch.clamp(nrm, min=1e-12), E0)
        inl_new = (geo.sampson_error(E_new, x1, x2) < threshold_sq) & maskb
        n_new = torch.sum(inl_new)
        keep = ok & (n_new >= n_inl // 2) if cfg.inlier_loss_guard else ok
        E = torch.where(keep, E_new, E)
        inl = torch.where(keep, inl_new, inl)
        n_inl = torch.where(keep, n_new, n_inl)
        ns_prev = torch.where(ok, ns, ns_prev)
    # support-guarded projection: a drifted raw-DLT iterate whose
    # projection loses the support falls back to projecting E0
    E_proj = geo.closest_essential_fast(E)
    n_proj = torch.sum(
        (geo.sampson_error(E_proj, x1, x2) < threshold_sq) & maskb)
    drifted = n_proj < torch.sum(inl_pre) // 2
    E = torch.where(drifted, geo.closest_essential_fast(E0), E_proj)
    err = geo.sampson_error(E, x1f, x2f)
    inl = (err < threshold_sq) & maskf
    n_inl = torch.sum(inl)
    mean = torch.sum(err * inl.to(err.dtype)) / torch.clamp(
        n_inl.to(err.dtype), min=1.0)
    return RefineResult(model=E, inlier_mask=inl, n_inliers=n_inl,
                        mean_sampson=mean)


def _exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: rotation vector (3,) -> rotation matrix (3, 3)."""
    th2 = torch.sum(w * w)
    th = torch.sqrt(th2 + 1e-24)
    K = geo.skew(w / th)
    s = torch.where(th2 > 1e-12, torch.sin(th), th)
    c1 = torch.where(th2 > 1e-12, 1.0 - torch.cos(th), 0.5 * th2)
    return torch.eye(3, dtype=w.dtype, device=w.device) + s * K + c1 * (K @ K)


def _t_basis(t: torch.Tensor) -> torch.Tensor:
    """Orthonormal (3, 2) basis of the unit sphere's tangent plane at t."""
    e = torch.nn.functional.one_hot(torch.argmin(torch.abs(t)), 3).to(t.dtype)
    b1 = torch.linalg.cross(t, e)
    b1 = b1 / torch.clamp(torch.linalg.norm(b1), min=1e-12)
    b2 = torch.linalg.cross(t, b1)
    b2 = b2 / torch.clamp(torch.linalg.norm(b2), min=1e-12)
    return torch.stack([b1, b2], dim=-1)


class PolishResult(NamedTuple):
    R: torch.Tensor  # (3, 3)
    t: torch.Tensor  # (3,) unit
    E: torch.Tensor  # (3, 3)
    cost: torch.Tensor  # final robust mean cost


def polish_pose_sampson(
    R: torch.Tensor,
    t: torch.Tensor,
    x1: torch.Tensor,
    x2: torch.Tensor,
    weights: torch.Tensor,
    threshold_sq,
    iterations: int = 12,
    rotation_only: bool = False,
) -> PolishResult:
    """Levenberg-Marquardt polish of the pseudo-Huber-robustified signed
    Sampson error over the (R, t) manifold, with a step-size convergence
    latch (tol 1e-5 rad)."""
    dt, dev = x1.dtype, x1.device
    th_l1 = torch.sqrt(torch.clamp(
        torch.as_tensor(threshold_sq, dtype=dt, device=dev), min=1e-18))
    inv_s = 1.0 / th_l1
    w_in = weights.to(dt)
    n_w = torch.clamp(torch.sum(w_in), min=1.0)
    ndof = 3 if rotation_only else 5

    def signed_sampson(Rc, tc):
        num, Ex1, Etx2 = geo.epipolar_products(geo.skew(tc) @ Rc, x1, x2)
        den = torch.sqrt(Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2
                         + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2)
        return num / torch.clamp(den, min=1e-12) * inv_s

    def robust_cost(r):
        return torch.sum(w_in * 2.0 * (torch.sqrt(1.0 + r * r) - 1.0)) / n_w

    Rc, tc = R, t
    cost = robust_cost(signed_sampson(R, t))
    lam = torch.tensor(1e-3, dtype=dt, device=dev)
    tol = torch.tensor(1e-5, dtype=dt, device=dev)
    eye = torch.eye(ndof, dtype=dt, device=dev)
    for _ in range(iterations):
        B = _t_basis(tc)

        def new_pose(p, Rc=Rc, tc=tc, B=B):
            Rn = Rc @ _exp_so3(p[:3])
            if rotation_only:
                return Rn, tc
            tn = tc + B @ p[3:]
            return Rn, tn / torch.clamp(torch.linalg.norm(tn), min=1e-12)

        def resid_raw(p):
            return signed_sampson(*new_pose(p))

        p0 = torch.zeros(ndof, dtype=dt, device=dev)
        r_raw = resid_raw(p0)
        # IRLS sqrt-weights (Huber influence at delta = 1), held constant
        # under differentiation
        wr = torch.sqrt(w_in / torch.sqrt(1.0 + r_raw ** 2))
        r0 = r_raw * wr
        J = jacfwd(resid_raw)(p0) * wr[:, None]
        H = J.T @ J
        g = J.T @ r0
        D = torch.diag(torch.diag(H)) + 1e-9 * eye
        # the JAX package's _solve_spd_small: the same unrolled Cholesky
        delta = smalllinalg.chol_solve_unrolled(H + lam * D, -g)
        R_new, t_new = new_pose(delta)
        cost_new = robust_cost(signed_sampson(R_new, t_new))
        ok = torch.isfinite(cost_new) & (cost_new < cost)
        Rc = torch.where(ok, R_new, Rc)
        tc = torch.where(ok, t_new, tc)
        cost = torch.where(ok, cost_new, cost)
        lam = torch.where(ok, lam * 0.33, lam * 4.0)
        done = (torch.sum(delta * delta) < tol * tol) | (lam > 1e8)
        if HostSyncs.read(done):
            break
    return PolishResult(R=Rc, t=tc, E=geo.skew(tc) @ Rc, cost=cost)


def polish_pose_iterative(
    R: torch.Tensor,
    t: torch.Tensor,
    x1: torch.Tensor,
    x2: torch.Tensor,
    inliers: torch.Tensor,
    valid_mask: torch.Tensor,
    threshold_sq,
    rounds: int = 3,
    iterations: int = 15,
    max_points: int | None = None,
) -> tuple[PolishResult, torch.Tensor]:
    """Alternate the LM polish with inlier re-selection from all valid
    slots until (pose, support) stop changing, on a compaction of at most
    max_points slots. Returns the final PolishResult and the boolean inlier
    mask over the full input."""
    dt = x1.dtype
    valid = valid_mask.to(torch.bool)
    n = x1.shape[0]
    x1c, x2c = x1, x2
    wc = inliers.to(dt)
    validc = valid
    if max_points is not None and max_points < n:
        score = valid_mask.to(dt) + (inliers > 0).to(dt)
        sel = geo.spread_select(score, max_points)
        x1c, x2c = x1[sel], x2[sel]
        wc = wc[sel]
        validc = valid[sel]

    cos_tol = torch.cos(torch.tensor(2e-5, dtype=dt, device=x1.device))
    cost = torch.tensor(torch.inf, dtype=dt, device=x1.device)
    for _ in range(rounds):
        pol = polish_pose_sampson(R, t, x1c, x2c, wc, threshold_sq,
                                  iterations=iterations)
        err = geo.sampson_error(pol.E, x1c, x2c)
        w_new = ((err < threshold_sq) & validc).to(dt)
        ctr = 0.5 * (torch.trace(pol.R @ R.T) - 1.0)
        rot_close = ctr > cos_tol
        t_close = torch.abs(torch.sum(pol.t * t)) > cos_tol
        done = rot_close & t_close & torch.all(w_new == wc)
        R, t, wc, cost = pol.R, pol.t, w_new, pol.cost
        if HostSyncs.read(done):
            break
    pol = PolishResult(R=R, t=t, E=geo.skew(t) @ R, cost=cost)
    err_full = geo.sampson_error(pol.E, x1, x2)
    return pol, (err_full < threshold_sq) & valid
