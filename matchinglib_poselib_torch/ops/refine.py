"""Linear IRLS refinement and the (R, t) Sampson polish (port of
``ops/refine.py``).

- ``refine_essential_linear``: IRLS on a shrinking threshold band with
  Torr / pseudo-Huber weights, the inlier-loss guard and the
  support-guarded manifold projection (pose_linear_refinement.cpp:85-640);
  with ``solver=KNEIP`` followed by the rotation eigensolver's polish
  (``ops/eigensolver.py``).
- ``polish_pose_sampson`` / ``polish_pose_iterative``: Levenberg-Marquardt
  over the 5-DOF pose manifold on the robustified signed Sampson error
  (closed-form Jacobian), alternated with inlier re-selection.

Each function takes an optional leading pair axis, as ``jax.vmap`` of the
JAX package's function: per-pair models, masks and thresholds. Fixed-count
loops are plain loops; the convergence latches of the JAX package's
``lax.while_loop``s read one flag (every pair done) on the host once per
iteration (``utils.profiling.HostSyncs``), and a pair that has converged
keeps its state.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from matchinglib_poselib_torch.config import (
    MinimalSolver,
    RefinementConfig,
    RefineWeights,
)
from matchinglib_poselib_torch.ops import geometry as geo
from matchinglib_poselib_torch.ops import eigensolver, smalllinalg, solvers
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
    classification runs on the full set. With ``solver=KNEIP`` the result
    is polished by the rotation eigensolver on the final inliers (the
    reference's Kneip RefineAlg rows, pose_estim.h:67-77; one pair only).

    E0 (..., 3, 3), x1, x2 (..., N, 2), mask (..., N) and threshold_sq
    (...) or shared take an optional leading pair axis."""
    dt, dev = x1.dtype, x1.device
    batch = x1.shape[:-2]
    if batch and cfg.solver == MinimalSolver.KNEIP:
        raise NotImplementedError(
            "refine_essential_linear: the KNEIP polish with a pair axis is "
            "not ported")
    maskb = mask.to(torch.bool)
    m = cfg.th_multiplier
    iters = cfg.iterations
    step = (m - 1.0) / max(iters, 1)
    th = torch.as_tensor(threshold_sq, dtype=dt, device=dev)[..., None]

    x1f, x2f, maskf = x1, x2, maskb
    cap = cfg.refine_max_points
    if cap is not None and cap < x1.shape[-2]:
        band_pre = (geo.sampson_error(E0, x1, x2) < m * th) & maskb
        score = band_pre.to(dt) + maskb.to(dt)
        sel = geo.spread_select(score, cap)
        x1, x2, maskb = (geo.take_rows(a, sel) for a in (x1, x2, maskb))

    err0 = geo.sampson_error(E0, x1, x2)
    inl0 = (err0 < m * th) & maskb
    x1n, T1 = geo.normalize_points(x1, inl0.to(dt))
    x2n, T2 = geo.normalize_points(x2, inl0.to(dt))
    A_rows = solvers.epipolar_rows(x1n, x2n)
    T2t = T2.transpose(-1, -2)

    inl_pre = (err0 < th) & maskb
    E, inl, n_inl = E0, inl_pre, torch.sum(inl_pre, dim=-1)
    ns_prev = (_inv_sim(T2).transpose(-1, -2) @ E0
               @ _inv_sim(T1)).reshape(batch + (9,))
    for i in range(iters):
        ip1 = torch.tensor(i + 1.0, dtype=dt, device=dev)
        th_i = (m - ip1 * step) * th
        err = geo.sampson_error(E, x1, x2)
        band = (err < th_i) & maskb
        w = _weights(E, x1, x2, err, th, cfg.weights) * band.to(dt)
        Aw = A_rows * w[..., None]
        ns = smalllinalg.min_eigvec_spd(Aw.transpose(-1, -2) @ Aw,
                                        iterations=2, v0=ns_prev)
        E_new = T2t @ ns.reshape(batch + (3, 3)) @ T1
        nrm = torch.sqrt(torch.sum(E_new * E_new, dim=(-2, -1)))
        ok = torch.isfinite(nrm) & (nrm > 1e-12)
        E_new = torch.where(
            ok[..., None, None],
            E_new / torch.clamp(nrm, min=1e-12)[..., None, None], E0)
        inl_new = (geo.sampson_error(E_new, x1, x2) < th) & maskb
        n_new = torch.sum(inl_new, dim=-1)
        keep = ok & (n_new >= n_inl // 2) if cfg.inlier_loss_guard else ok
        E = torch.where(keep[..., None, None], E_new, E)
        inl = torch.where(keep[..., None], inl_new, inl)
        n_inl = torch.where(keep, n_new, n_inl)
        ns_prev = torch.where(ok[..., None], ns, ns_prev)
    # support-guarded projection: a drifted raw-DLT iterate whose
    # projection loses the support falls back to projecting E0
    E_proj = geo.closest_essential_fast(E)
    n_proj = torch.sum(
        (geo.sampson_error(E_proj, x1, x2) < th) & maskb, dim=-1)
    drifted = n_proj < torch.sum(inl_pre, dim=-1) // 2
    E = torch.where(drifted[..., None, None],
                    geo.closest_essential_fast(E0), E_proj)
    if cfg.solver == MinimalSolver.KNEIP:
        E, inl = _kneip_polish(E, x1, x2, inl, maskb, threshold_sq)
    err = geo.sampson_error(E, x1f, x2f)
    inl = (err < th) & maskf
    n_inl = torch.sum(inl, dim=-1)
    mean = torch.sum(err * inl.to(err.dtype), dim=-1) / torch.clamp(
        n_inl.to(err.dtype), min=1.0)
    return RefineResult(model=E, inlier_mask=inl, n_inliers=n_inl,
                        mean_sampson=mean)


def _kneip_polish(E, x1, x2, inl, maskb, threshold_sq):
    """Eigensolver polish of E on its inliers, kept only on strictly more
    inliers, or as many at a lower mean Sampson error, and never when the
    polished model is empty or not finite."""
    kn = eigensolver.refine_essential_kneip(E, x1, x2, inl)
    err_k = geo.sampson_error(kn.E, x1, x2)
    inl_k = (err_k < threshold_sq) & maskb
    n_k = torch.sum(inl_k)
    n_cur = torch.sum(inl)
    err_cur = geo.sampson_error(E, x1, x2)

    def mean_inl(e, m):
        n = torch.clamp(torch.sum(m.to(e.dtype)), min=1.0)
        return torch.sum(torch.where(m, e, 0.0)) / n

    keep = (n_k > 0) & torch.all(torch.isfinite(kn.E)) & (
        (n_k > n_cur)
        | ((n_k == n_cur) & (mean_inl(err_k, inl_k) < mean_inl(err_cur, inl)))
    )
    return torch.where(keep, kn.E, E), torch.where(keep, inl_k, inl)


def _exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: rotation vectors (..., 3) -> rotation matrices
    (..., 3, 3)."""
    th2 = torch.sum(w * w, dim=-1)
    th = torch.sqrt(th2 + 1e-24)
    K = geo.skew(w / th[..., None])
    small = th2 > 1e-12
    s = torch.where(small, torch.sin(th), th)[..., None, None]
    c1 = torch.where(small, 1.0 - torch.cos(th), 0.5 * th2)[..., None, None]
    return torch.eye(3, dtype=w.dtype, device=w.device) + s * K + c1 * (K @ K)


def _t_basis(t: torch.Tensor) -> torch.Tensor:
    """Orthonormal (..., 3, 2) basis of the unit sphere's tangent plane at
    t (..., 3)."""
    e = torch.nn.functional.one_hot(torch.argmin(torch.abs(t), dim=-1),
                                    3).to(t.dtype)
    b1 = torch.linalg.cross(t, e, dim=-1)
    b1 = b1 / torch.clamp(torch.linalg.norm(b1, dim=-1, keepdim=True),
                          min=1e-12)
    b2 = torch.linalg.cross(t, b1, dim=-1)
    b2 = b2 / torch.clamp(torch.linalg.norm(b2, dim=-1, keepdim=True),
                          min=1e-12)
    return torch.stack([b1, b2], dim=-1)


def _new_pose(R, t, B, p):
    """The LM step's pose at parameters p (..., ndof): R exp([p_:3]x) and,
    when the tangent basis B (..., 3, 2) is given, t + B p_3: renormalized
    (else t)."""
    Rn = R @ _exp_so3(p[..., :3])
    if B is None:
        return Rn, t
    tn = t + (B @ p[..., 3:, None])[..., 0]
    return Rn, tn / torch.clamp(torch.linalg.norm(tn, dim=-1, keepdim=True),
                                min=1e-12)


def _signed_sampson(R, t, x1, x2, inv_s):
    """Signed Sampson residual (..., N) of E = [t]x R, times inv_s (...,
    1), and its parts (E, num, Ex1, Etx2, den clamped at 1e-12)."""
    E = geo.skew(t) @ R
    num, Ex1, Etx2 = geo.epipolar_products(E, x1, x2)
    den = torch.sqrt(Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2
                     + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2)
    den_c = torch.clamp(den, min=1e-12)
    return num / den_c * inv_s, (E, num, Ex1, Etx2, den_c)


def _signed_sampson_jacobian(R, t, B, x1, x2, inv_s):
    """The signed Sampson residual r (..., N) at (R, t) and its closed-form
    derivative J (..., N, ndof) in the LM step's parameters at 0
    (``_new_pose``): the rotation vector w of R exp([w]x), dE/dw_k =
    E [e_k]x, and, with a tangent basis B, the coefficients b of the
    renormalized t + B b, dE/db_j = [(I - t t^T / |t|^2) B_j / |t|]x R."""
    r, (E, num, Ex1, Etx2, den_c) = _signed_sampson(R, t, x1, x2, inv_s)
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    dE = E[..., None, :, :] @ geo.skew(eye)
    if B is not None:
        tn2 = torch.sum(t * t, dim=-1)[..., None, None]
        dt = (B - t[..., :, None] * (t[..., None, :] @ B) / tn2) / torch.sqrt(
            tn2)
        dE = torch.cat([dE, geo.skew(dt.transpose(-1, -2))
                        @ R[..., None, :, :]], dim=-3)
    dnum, dEx1, dEtx2 = geo.epipolar_products(
        dE, x1[..., None, :, :], x2[..., None, :, :])
    Ex1, Etx2 = Ex1[..., None, :, :], Etx2[..., None, :, :]
    dden = (Ex1[..., 0] * dEx1[..., 0] + Ex1[..., 1] * dEx1[..., 1]
            + Etx2[..., 0] * dEtx2[..., 0]
            + Etx2[..., 1] * dEtx2[..., 1]) / den_c[..., None, :]
    # the clamp's derivative: none below 1e-12
    dden = torch.where(den_c[..., None, :] > 1e-12, dden, 0.0)
    J = (dnum - num[..., None, :] * dden / den_c[..., None, :]) / den_c[
        ..., None, :] * inv_s[..., None, :]
    return r, J.transpose(-1, -2)


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
    live: torch.Tensor | None = None,
) -> PolishResult:
    """Levenberg-Marquardt polish of the pseudo-Huber-robustified signed
    Sampson error over the (R, t) manifold, with a step-size convergence
    latch (tol 1e-5 rad) and the closed-form Jacobian
    (``_signed_sampson_jacobian``).

    R (..., 3, 3), t (..., 3), x1, x2 (..., N, 2), weights (..., N),
    threshold_sq (...) or shared take an optional leading pair axis; each
    pair stops on its own latch and then keeps its pose, cost and damping.
    live: (...) bool, the pairs to polish (default all); the others are
    returned as given."""
    dt, dev = x1.dtype, x1.device
    batch = x1.shape[:-2]
    th_l1 = torch.sqrt(torch.clamp(
        torch.as_tensor(threshold_sq, dtype=dt, device=dev), min=1e-18))
    inv_s = (1.0 / th_l1)[..., None]
    w_in = weights.to(dt)
    n_w = torch.clamp(torch.sum(w_in, dim=-1), min=1.0)
    ndof = 3 if rotation_only else 5

    def robust_cost(r):
        return torch.sum(w_in * 2.0 * (torch.sqrt(1.0 + r * r) - 1.0),
                         dim=-1) / n_w

    Rc, tc = R, t
    cost = robust_cost(_signed_sampson(R, t, x1, x2, inv_s)[0])
    lam = torch.full(batch, 1e-3, dtype=dt, device=dev)
    tol = torch.tensor(1e-5, dtype=dt, device=dev)
    eye = torch.eye(ndof, dtype=dt, device=dev)
    if live is None:
        live = torch.ones(batch, dtype=torch.bool, device=dev)
    for it in range(iterations):
        B = None if rotation_only else _t_basis(tc)
        r_raw, J = _signed_sampson_jacobian(Rc, tc, B, x1, x2, inv_s)
        # IRLS sqrt-weights (Huber influence at delta = 1), held constant
        # under differentiation
        wr = torch.sqrt(w_in / torch.sqrt(1.0 + r_raw ** 2))
        # H = J^T J and g = J^T r from one product of [J | r]
        Jr = torch.cat([J, r_raw[..., None]], dim=-1) * wr[..., None]
        JtJr = Jr.transpose(-1, -2) @ Jr
        H, g = JtJr[..., :ndof, :ndof], JtJr[..., :ndof, ndof]
        D = torch.diag_embed(torch.diagonal(H, dim1=-2, dim2=-1)) + 1e-9 * eye
        # the JAX package's _solve_spd_small: the same unrolled Cholesky
        delta = smalllinalg.chol_solve_unrolled(
            H + lam[..., None, None] * D, -g)
        R_new, t_new = _new_pose(Rc, tc, B, delta)
        cost_new = robust_cost(_signed_sampson(R_new, t_new, x1, x2,
                                               inv_s)[0])
        ok = live & torch.isfinite(cost_new) & (cost_new < cost)
        Rc = torch.where(ok[..., None, None], R_new, Rc)
        tc = torch.where(ok[..., None], t_new, tc)
        cost = torch.where(ok, cost_new, cost)
        lam = torch.where(live, torch.where(ok, lam * 0.33, lam * 4.0), lam)
        done = (torch.sum(delta * delta, dim=-1) < tol * tol) | (lam > 1e8)
        live = live & ~done
        if not HostSyncs.read(torch.any(live), "polish_lm", it):
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
    point_weights: torch.Tensor | None = None,
    rotation_only: bool = False,
) -> tuple[PolishResult, torch.Tensor]:
    """Alternate the LM polish with inlier re-selection from all valid
    slots until (pose, support) stop changing, on a compaction of at most
    max_points slots. point_weights: optional (N,) per-point quality
    weights (clamped at 1e-3) multiplied into the LM support of every
    round, re-selection included; rotation_only: polish R alone. Takes an
    optional leading pair axis (``polish_pose_sampson``); each pair stops
    at its own fixed point and keeps it. Returns the final PolishResult
    and the boolean inlier mask over the full input."""
    dt, dev = x1.dtype, x1.device
    batch = x1.shape[:-2]
    valid = valid_mask.to(torch.bool)
    n = x1.shape[-2]
    th = torch.as_tensor(threshold_sq, dtype=dt, device=dev)[..., None]
    x1c, x2c = x1, x2
    wc = inliers.to(dt)
    validc = valid
    pw = None if point_weights is None else point_weights.to(dt)
    if max_points is not None and max_points < n:
        score = valid_mask.to(dt) + (inliers > 0).to(dt)
        sel = geo.spread_select(score, max_points)
        x1c, x2c, wc, validc = (geo.take_rows(a, sel)
                                for a in (x1, x2, wc, valid))
        if pw is not None:
            pw = geo.take_rows(pw, sel)
    if pw is not None:
        pw = torch.clamp(pw, min=1e-3)
        wc = wc * pw

    cos_tol = torch.cos(torch.tensor(2e-5, dtype=dt, device=dev))
    cost = torch.full(batch, torch.inf, dtype=dt, device=dev)
    live = torch.ones(batch, dtype=torch.bool, device=dev)
    for r in range(rounds):
        pol = polish_pose_sampson(R, t, x1c, x2c, wc, threshold_sq,
                                  iterations=iterations,
                                  rotation_only=rotation_only, live=live)
        err = geo.sampson_error(pol.E, x1c, x2c)
        w_new = ((err < th) & validc).to(dt)
        if pw is not None:
            w_new = w_new * pw
        ctr = 0.5 * (torch.diagonal(pol.R @ R.transpose(-1, -2), dim1=-2,
                                    dim2=-1).sum(-1) - 1.0)
        rot_close = ctr > cos_tol
        t_close = torch.abs(torch.sum(pol.t * t, dim=-1)) > cos_tol
        done = rot_close & t_close & torch.all(w_new == wc, dim=-1)
        R = torch.where(live[..., None, None], pol.R, R)
        t = torch.where(live[..., None], pol.t, t)
        wc = torch.where(live[..., None], w_new, wc)
        cost = torch.where(live, pol.cost, cost)
        live = live & ~done
        if not HostSyncs.read(torch.any(live), "polish_rounds", r):
            break
    pol = PolishResult(R=R, t=t, E=geo.skew(t) @ R, cost=cost)
    err_full = geo.sampson_error(pol.E, x1, x2)
    return pol, (err_full < th) & valid
