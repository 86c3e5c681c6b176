"""Batched robust essential-matrix estimation (port of ``ops/robust.py``,
default path).

USAC/PROSAC hypothesis batches of the five-point solver scored densely,
with the half-uniform mixed pool, zero-inlier threshold inflation, the
adaptive confidence stop bounded by the SPRT prior, LO re-fits with the
support-guarded projection, and the degeneracy check (homography,
rotation-only and no-motion families on the E-inliers).

Randomness: every sampled uniform is an explicit tensor. ``ransac`` takes
``uniforms`` of shape (max_batches, B, k) — batch i uses uniforms[i], the
counterpart of ``jax.random.uniform(fold_in(key, i), (B, k))`` — or draws
them from a ``torch.Generator``. The JAX package's ``lax.while_loop``s are
Python loops that read their exit flag on the host once per iteration
(``utils.profiling.HostSyncs``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from matchinglib_poselib_torch.config import (
    MinimalSolver,
    PoseEstimator,
    RobustConfig,
)
from matchinglib_poselib_torch.ops import geometry as geo
from matchinglib_poselib_torch.ops import smalllinalg, solvers
from matchinglib_poselib_torch.utils.profiling import HostSyncs


class ModelFamily(NamedTuple):
    """A minimal-solver family pluggable into the robust engine."""

    name: str
    sample_size: int
    models_per_sample: int
    # (B, k, 2), (B, k, 2) -> (B, m, 3, 3), (B, m)
    solve: Callable
    # (M, 3, 3), (N, 2), (N, 2) -> (M, N) squared residuals
    error: Callable


def _sampson_family_error(E, x1, x2):
    return geo.sampson_error(E, x1[None], x2[None])


def essential_family(
    solver: MinimalSolver = MinimalSolver.NISTER_5PT,
    tables: solvers.SolverTables | None = None,
) -> ModelFamily:
    """Five-point essential family (Nister closed form). The Stewenius
    solver of the JAX package is not ported yet."""
    if solver == MinimalSolver.STEWENIUS_5PT:
        raise NotImplementedError("the Stewenius 5pt solver is not ported")

    def solve(x1, x2):
        return solvers.solve_5pt_nister(x1, x2, tables)

    return ModelFamily("essential_5pt_nister", 5, 10, solve,
                       _sampson_family_error)


def essential_8pt_family() -> ModelFamily:
    def solve(x1, x2):
        E, v = solvers.solve_8pt(x1, x2)
        return E[:, None], v[:, None]

    return ModelFamily("essential_8pt", 8, 1, solve, _sampson_family_error)


def homography_family() -> ModelFamily:
    def solve(x1, x2):
        H, v = solvers.solve_homography(x1, x2)
        return H[:, None], v[:, None]

    def err(H, x1, x2):
        return solvers.homography_transfer_error(H, x1[None], x2[None])

    return ModelFamily("homography_4pt", 4, 1, solve, err)


class RobustResult(NamedTuple):
    model: torch.Tensor  # (3, 3)
    inlier_mask: torch.Tensor  # (N,) bool
    n_inliers: torch.Tensor  # int
    inlier_ratio: torch.Tensor  # f32 (vs valid correspondences)
    score: torch.Tensor  # engine score of the best model
    threshold: torch.Tensor  # (possibly inflated) squared threshold used
    n_batches: torch.Tensor  # batches executed
    n_hypotheses: torch.Tensor  # total models scored
    n_models_generated: torch.Tensor | int = 0
    n_models_rejected: torch.Tensor | int = 0
    n_points_verified: torch.Tensor | int = 0
    n_lo_refinements: torch.Tensor | int = 0


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------


def sample_without_replacement(u: torch.Tensor, pool_sizes: torch.Tensor,
                               k: int, n_total: int) -> torch.Tensor:
    """k distinct indices in [0, pool_b) per row from uniforms u (B, k).

    Shifted-draw scheme: draw r_j in [0, pool - j) and shift it past the
    previously chosen indices in ascending order (exact uniformity, no
    rejection).
    """
    B = pool_sizes.shape[0]
    chosen = torch.full((B, k), n_total + 7, dtype=torch.int64,
                        device=u.device)
    for j in range(k):
        pool_j = torch.clamp(pool_sizes - j, min=1)
        r = torch.minimum((u[:, j] * pool_j).to(torch.int64), pool_j - 1)
        sorted_prev = torch.sort(chosen, dim=1).values
        for jj in range(k):
            r = torch.where(r >= sorted_prev[:, jj], r + 1, r)
        chosen[:, j] = r
    return chosen


def prosac_pool_schedule(batch_idx: int, n_valid: torch.Tensor,
                         sample_size: int, max_batches: int) -> torch.Tensor:
    """Geometric sampling-pool growth per batch: from ~4x sample_size to
    all valid matches (USAC.h generatePROSACMinSample at batch grain)."""
    n_valid = torch.clamp(n_valid, min=sample_size + 2)
    start = torch.clamp(n_valid, max=4 * sample_size)
    frac = torch.clamp(
        torch.tensor(batch_idx + 1.0, dtype=torch.float32,
                     device=n_valid.device) / float(max(max_batches - 1, 1)),
        max=1.0,
    )
    pool = start.to(torch.float32) * (
        n_valid.to(torch.float32) / start) ** frac
    return torch.minimum(torch.ceil(pool).to(torch.int64), n_valid)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def _score_models(models, mvalid, err_fn, x1, x2, mask, th_sq):
    """Score (M, 3, 3) models: inlier count with an MSAC-style truncated
    error tiebreak. Returns (score, counts, err)."""
    err = err_fn(models, x1, x2)
    maskf = mask.to(err.dtype)[None]
    inl = (err < th_sq) & (maskf > 0)
    counts = torch.sum(inl, dim=-1)
    trunc = torch.sum(torch.minimum(err, th_sq) * maskf, dim=-1)
    score = counts.to(err.dtype) - trunc / (th_sq * (torch.sum(maskf) + 1.0))
    return torch.where(mvalid, score, -torch.inf), counts, err


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def draw_uniforms(generator: torch.Generator | None, shape, device):
    """Uniforms in [0, 1) from an explicit generator (on its device)."""
    gen_dev = generator.device if generator is not None else device
    return torch.rand(shape, generator=generator, device=gen_dev).to(device)


def ransac(
    family: ModelFamily,
    x1: torch.Tensor,
    x2: torch.Tensor,
    mask: torch.Tensor,
    quality: torch.Tensor | None,
    cfg: RobustConfig,
    threshold_sq=None,
    prior_inlier_ratio=None,
    uniforms: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> RobustResult:
    """Batched robust estimation of one model on one correspondence set.

    x1, x2: (N, 2) normalized coords (padded); mask: (N,) validity;
    quality: (N,) higher = better (PROSAC order; None = no PROSAC).
    uniforms: (max_batches, B, k) sample uniforms, else drawn from
    `generator`. LMEDS and the other estimators of the JAX package's menu
    are not ported yet.
    """
    if cfg.estimator == PoseEstimator.LMEDS:
        raise NotImplementedError("LMEDS scoring is not ported")
    dev, dt = x1.device, x1.dtype
    N = x1.shape[0]
    if threshold_sq is None:
        threshold_sq = cfg.threshold_px ** 2
    th_sq = torch.as_tensor(threshold_sq, dtype=dt, device=dev)
    B = cfg.batch_hypotheses
    k = family.sample_size
    if uniforms is None:
        uniforms = draw_uniforms(generator, (cfg.max_batches, B, k), dev)

    maskb = mask.to(torch.bool)
    n_valid = torch.sum(maskb.to(torch.int64))
    use_prosac = quality is not None and cfg.prosac
    q = quality.to(dt) if use_prosac else torch.zeros((N,), dtype=dt,
                                                      device=dev)
    order = torch.argsort(torch.where(maskb, -q, torch.inf), stable=True)

    log_conf = torch.log(_f32(1.0 - cfg.confidence, x1))
    if prior_inlier_ratio is not None:
        eps = torch.clamp(
            torch.as_tensor(prior_inlier_ratio, dtype=torch.float32,
                            device=dev), 0.0, 0.95)
        hyp_needed = log_conf / torch.log1p(
            -torch.clamp(eps**k, 1e-12, 1.0 - 1e-7))

    best_score = torch.tensor(-torch.inf, dtype=dt, device=dev)
    best_count = torch.zeros((), dtype=torch.int64, device=dev)
    best_model = torch.eye(3, dtype=dt, device=dev)
    n_rej = torch.zeros((), dtype=torch.int64, device=dev)
    i = 0
    while i < cfg.max_batches:
        # zero-inlier threshold inflation (USAC.h:355-364)
        if cfg.inflate_th_on_failure:
            if i == cfg.max_batches // 2:
                th_sq = torch.where(best_count <= k, th_sq * (1.33**2), th_sq)
            if i == (2 * cfg.max_batches) // 3:
                th_sq = torch.where(best_count <= k, th_sq * (1.13**2), th_sq)
        if use_prosac:
            pool = prosac_pool_schedule(i, n_valid, k, cfg.max_batches)
            pool = pool.expand(B).clone()
            # half of every batch samples the full valid pool: the
            # confidence stop assumes full-population draws
            pool[B // 2:] = torch.clamp(n_valid, min=k)
        else:
            pool = torch.clamp(n_valid, min=k).expand(B)
        idx = order[sample_without_replacement(uniforms[i], pool, k, N)]
        models, mvalid = family.solve(x1[idx], x2[idx])
        M = B * family.models_per_sample
        models = models.reshape(M, 3, 3)
        mvalid = mvalid.reshape(M)
        score, counts, _ = _score_models(
            models, mvalid, family.error, x1, x2, maskb, th_sq
        )
        best = torch.argmax(score)
        n_rej = n_rej + torch.sum(~mvalid)
        better = score[best] > best_score
        best_score = torch.where(better, score[best], best_score)
        best_count = torch.where(better, counts[best], best_count)
        best_model = torch.where(better, models[best], best_model)
        # adaptive stopping: P(miss) = (1 - w^k)^(hyps so far) < 1 - conf
        n_hyp = _f32((i + 1.0) * B * family.models_per_sample, x1)
        w = best_count.to(torch.float32) / torch.clamp(
            n_valid.to(torch.float32), min=1.0)
        log_pmiss = n_hyp * torch.log1p(
            -torch.clamp(w**k, 1e-12, 1.0 - 1e-7))
        done = log_pmiss < log_conf
        if prior_inlier_ratio is not None:
            prior_ok = (
                (n_hyp >= hyp_needed)
                & (best_count.to(torch.float32)
                   >= 0.5 * eps * n_valid.to(torch.float32))
                & (best_count > k)
            )
            done = done | prior_ok
        i += 1
        if HostSyncs.read(done):
            break

    err = family.error(best_model[None], x1, x2)[0]
    inl = (err < th_sq) & maskb
    n_inl = torch.sum(inl)
    ratio = n_inl.to(torch.float32) / torch.clamp(
        n_valid.to(torch.float32), min=1.0)
    n_generated = torch.tensor(i * B * family.models_per_sample, device=dev)
    return RobustResult(
        model=best_model,
        inlier_mask=inl,
        n_inliers=n_inl,
        inlier_ratio=ratio,
        score=best_score,
        threshold=th_sq,
        n_batches=torch.tensor(i, device=dev),
        n_hypotheses=n_generated,
        n_models_generated=n_generated,
        n_models_rejected=n_rej,
        n_points_verified=(n_generated - n_rej) * n_valid,
        n_lo_refinements=torch.zeros((), dtype=torch.int64, device=dev),
    )


def _inv_sim(T: torch.Tensor) -> torch.Tensor:
    """Inverse of the similarity [[s, 0, tx], [0, s, ty], [0, 0, 1]]."""
    s = T[0, 0]
    z = torch.zeros_like(s)
    o = torch.ones_like(s)
    return torch.stack([
        torch.stack([1.0 / s, z, -T[0, 2] / s]),
        torch.stack([z, 1.0 / s, -T[1, 2] / s]),
        torch.stack([z, z, o]),
    ])


# ---------------------------------------------------------------------------
# local optimization (LOSAC analogue)
# ---------------------------------------------------------------------------


def lo_refine_essential(result: RobustResult, x1, x2, mask,
                        iterations: int = 4) -> RobustResult:
    """Iterative pseudo-Huber-weighted 8pt re-fit on the current inliers
    (USAC.h locallyOptimizeSolution); keeps a re-fit only if the inlier
    count does not drop, and stops once a re-fit reproduces the model."""
    th = result.threshold
    maskb = mask.to(torch.bool)
    inl0f = result.inlier_mask.to(x1.dtype)
    x1n, T1 = geo.normalize_points(x1, inl0f)
    x2n, T2 = geo.normalize_points(x2, inl0f)
    A_rows = solvers.epipolar_rows(x1n, x2n)
    T2t = T2.transpose(-1, -2)

    model, inl, n_inl = result.model, result.inlier_mask, result.n_inliers
    n_lo = torch.zeros((), dtype=torch.int64, device=x1.device)
    ns_prev = (_inv_sim(T2).T @ result.model @ _inv_sim(T1)).reshape(9)
    for _ in range(iterations):
        err = geo.sampson_error(model, x1, x2)
        b2 = torch.clamp(th, min=1e-20)
        w = 1.0 / torch.sqrt(torch.sqrt(1.0 + err / b2))
        w = w * inl.to(w.dtype)
        Aw = A_rows * w[:, None]
        ns = smalllinalg.min_eigvec_spd(Aw.T @ Aw, iterations=2, v0=ns_prev)
        E_new = T2t @ ns.reshape(3, 3) @ T1
        nrm = torch.sqrt(torch.sum(E_new * E_new))
        ok = torch.isfinite(nrm) & (nrm > 1e-12)
        E_new = torch.where(ok, E_new / torch.clamp(nrm, min=1e-12), model)
        inl_new = (geo.sampson_error(E_new, x1, x2) < th) & maskb
        n_new = torch.sum(inl_new)
        keep = ok & (n_new >= n_inl)
        d1 = torch.sum((E_new - model) ** 2)
        d2 = torch.sum((E_new + model) ** 2)
        done = keep & (torch.minimum(d1, d2) < 1e-14)
        model = torch.where(keep, E_new, model)
        inl = torch.where(keep, inl_new, inl)
        n_inl = torch.where(keep, n_new, n_inl)
        n_lo = n_lo + keep.to(torch.int64)
        ns_prev = torch.where(ok, ns, ns_prev)
        if HostSyncs.read(done):
            break
    n_valid = torch.clamp(torch.sum(maskb.to(torch.float32)), min=1.0)
    return result._replace(
        model=model, inlier_mask=inl, n_inliers=n_inl,
        inlier_ratio=n_inl.to(torch.float32) / n_valid,
        n_lo_refinements=n_lo,
    )


# ---------------------------------------------------------------------------
# degeneracy analysis (QDEGSAC / USAC degeneracy semantics)
# ---------------------------------------------------------------------------


class DegeneracyResult(NamedTuple):
    is_degenerate: torch.Tensor  # bool: E is unreliable
    h_fraction: torch.Tensor  # fraction of E-inliers explained by one H
    rot_fraction: torch.Tensor  # fraction explained by pure rotation
    static_fraction: torch.Tensor  # fraction explained by no motion
    H: torch.Tensor  # (3, 3) dominant homography
    R_rotonly: torch.Tensor  # (3, 3) rotation-only model
    h_inliers: torch.Tensor | int = 0
    rot_inliers: torch.Tensor | int = 0
    static_inliers: torch.Tensor | int = 0


def rotation_only_model(x1, x2, weights):
    """Closed-form rotation-only fit via Horn's quaternion method (largest
    eigenvector of the 4x4 Davenport matrix)."""
    b1 = geo.normalize_vec(geo.to_homogeneous(x1))
    b2 = geo.normalize_vec(geo.to_homogeneous(x2))
    Bm = torch.einsum("...ni,...nj->...ij", b2 * weights[..., None], b1)
    tr = Bm[..., 0, 0] + Bm[..., 1, 1] + Bm[..., 2, 2]
    z = torch.stack([
        Bm[..., 1, 2] - Bm[..., 2, 1],
        Bm[..., 2, 0] - Bm[..., 0, 2],
        Bm[..., 0, 1] - Bm[..., 1, 0],
    ], dim=-1)
    S = Bm + Bm.transpose(-1, -2)
    eye = torch.eye(3, dtype=Bm.dtype, device=Bm.device)
    lower = S - tr[..., None, None] * eye
    top = torch.cat([tr[..., None, None], z[..., None, :]], dim=-1)
    bottom = torch.cat([z[..., :, None], lower], dim=-1)
    K = torch.cat([top, bottom], dim=-2)
    _, vecs = torch.linalg.eigh(K)
    q = vecs[..., :, -1]
    # this K convention yields the rotation taking b2 -> b1; return b1 -> b2
    return geo.rot_from_quat(q).transpose(-1, -2)


def analyze_degeneracy(E_result: RobustResult, x1, x2, mask,
                       cfg: RobustConfig, uniforms=None,
                       generator=None) -> DegeneracyResult:
    """Score H / rotation-only / no-motion families on the E-inliers
    (pose_estim.cpp:1983-2130 decision rule). uniforms: (1, Bh, 4) for the
    one-batch homography RANSAC, Bh = min(batch_hypotheses, 64)."""
    th = E_result.threshold
    inl = E_result.inlier_mask
    n_inl = torch.clamp(E_result.n_inliers.to(torch.float32), min=1.0)
    hcfg = RobustConfig(
        estimator=PoseEstimator.RANSAC,
        solver=MinimalSolver.HOMOGRAPHY,
        batch_hypotheses=min(cfg.batch_hypotheses, 64),
        max_batches=1,
        prosac=False,
        lo_refine=False,
        inflate_th_on_failure=False,
        check_degeneracy=False,
    )
    hres = ransac(homography_family(), x1, x2, inl, None, hcfg,
                  threshold_sq=th, uniforms=uniforms, generator=generator)
    h_frac = hres.n_inliers.to(torch.float32) / n_inl

    R_ro = rotation_only_model(x1, x2, inl.to(x1.dtype))
    b1 = geo.normalize_vec(geo.to_homogeneous(x1))
    b1r = b1 @ R_ro.transpose(-1, -2)
    pr = b1r[..., :2] / torch.clamp(torch.abs(b1r[..., 2:]), min=1e-9) * (
        torch.sign(b1r[..., 2:]))
    rot_err = torch.sum((pr - x2) ** 2, dim=-1)
    rot_inl = (rot_err < th) & inl
    rot_frac = torch.sum(rot_inl).to(torch.float32) / n_inl

    static_err = torch.sum((x2 - x1) ** 2, dim=-1)
    static_inl = (static_err < th) & inl
    static_frac = torch.sum(static_inl).to(torch.float32) / n_inl

    ratio = cfg.degen_decision_ratio
    is_degen = (h_frac > ratio) | (rot_frac > ratio) | (static_frac > ratio)
    return DegeneracyResult(
        is_degenerate=is_degen, h_fraction=h_frac, rot_fraction=rot_frac,
        static_fraction=static_frac, H=hres.model, R_rotonly=R_ro,
        h_inliers=hres.n_inliers, rot_inliers=torch.sum(rot_inl),
        static_inliers=torch.sum(static_inl),
    )


# ---------------------------------------------------------------------------
# top level
# ---------------------------------------------------------------------------


def estimate_essential_robust(
    x1: torch.Tensor,
    x2: torch.Tensor,
    mask: torch.Tensor,
    quality: torch.Tensor | None,
    cfg: RobustConfig,
    threshold_sq=None,
    prior_inlier_ratio=None,
    uniforms: torch.Tensor | None = None,
    degen_uniforms: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    tables: solvers.SolverTables | None = None,
):
    """Robust E: RANSAC/PROSAC batches + LO refinement + support-guarded
    projection + degeneracy check (estimateEssentialMat,
    pose_estim.cpp:857,1737). Returns (RobustResult, DegeneracyResult |
    None).

    uniforms: (max_batches, B, k) for the E batches; degen_uniforms:
    (1, min(B, 64), 4) for the degeneracy H batch (the JAX package's
    fold_in(key, 777) stream); either, when None, comes from `generator`.
    """
    if cfg.solver == MinimalSolver.EIGHT_PT:
        family = essential_8pt_family()
    else:
        family = essential_family(cfg.solver, tables)
    res = ransac(family, x1, x2, mask, quality, cfg, threshold_sq,
                 prior_inlier_ratio=prior_inlier_ratio, uniforms=uniforms,
                 generator=generator)
    if cfg.lo_refine:
        res0 = res
        res = lo_refine_essential(res, x1, x2, mask, cfg.lo_inner_iterations)
        # keep the LO outcome only if its PROJECTED support does not fall
        # below the pre-LO support (the raw-DLT chain can drift toward a
        # fundamental-matrix solution), else restore the ransac winner
        E_proj = geo.closest_essential(res.model)
        inl_p = (geo.sampson_error(E_proj, x1, x2) < res.threshold) & (
            mask.to(torch.bool))
        n_p = torch.sum(inl_p)
        keep_lo = n_p >= res0.n_inliers
        res = res._replace(
            model=torch.where(keep_lo, E_proj, res0.model),
            inlier_mask=torch.where(keep_lo, inl_p, res0.inlier_mask),
            n_inliers=torch.where(keep_lo, n_p, res0.n_inliers),
            n_lo_refinements=torch.where(
                keep_lo, res.n_lo_refinements,
                torch.zeros_like(res.n_lo_refinements)),
        )
    degen = None
    if cfg.check_degeneracy:
        degen = analyze_degeneracy(res, x1, x2, mask, cfg,
                                   uniforms=degen_uniforms,
                                   generator=generator)
    return res, degen

