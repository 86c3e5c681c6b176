"""Batched robust model estimation (port of ``ops/robust.py``).

USAC/PROSAC hypothesis batches of a five-point solver (Nister or
Stewenius) scored densely,
with the half-uniform mixed pool, zero-inlier threshold inflation, the
adaptive confidence stop bounded by the SPRT prior, LO re-fits with the
support-guarded projection, and the degeneracy check (homography,
rotation-only and no-motion families on the E-inliers); LMEDS
(runLMeDS, modelest.cpp:483) scores by the median residual over every
batch and classifies with the 2.5 * 1.4826 * sqrt(median) band;
``estimate_essential_autoth`` adapts the threshold between rounds of it
(AutoThEpi). The library-only estimators run on the same engine:
``estimate_fundamental_robust`` (7pt or 8pt), ``estimate_rotation_robust``,
``estimate_nomotion_robust`` (one dense pass) and QDEGSAC
(``estimate_essential_qdegsac``).

Pair axis: the default path (``ransac``, LO, the degeneracy check,
``estimate_essential_robust``) takes an optional leading pair axis P on
every per-pair input — x1, x2 (P, N, 2), mask and quality (P, N), the
threshold (P,) or shared — and returns per-pair results, what
``jax.vmap`` of the JAX package's functions returns: a loop runs until
every pair has exited, and a pair that has exited keeps its state and
counters.

Randomness: every sampled uniform is an explicit tensor. ``ransac`` takes
``uniforms`` of shape (max_batches, B, k), or (P, max_batches, B, k) with
a pair axis — batch i uses uniforms[..., i, :, :], the counterpart of
``jax.random.uniform(fold_in(key, i), (B, k))`` — or draws them from a
``torch.Generator`` (``estimate_essential_robust``: pair by pair). The
JAX package's ``lax.while_loop``s are Python loops that read one exit
flag (every pair done) on the host once per iteration
(``utils.profiling.HostSyncs``); LMEDS's batch loop has no exit and reads
none.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from matchinglib_poselib_torch.config import (
    MIN_PIX_TH,
    PIX_MIN_GOOD_TH,
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
    # (S, k, 2), (S, k, 2) -> (S, m, 3, 3), (S, m)
    solve: Callable
    # (..., M, 3, 3), (..., N, 2), (..., N, 2) -> (..., M, N) squared
    # residuals
    error: Callable


def _sampson_family_error(E, x1, x2):
    return geo.sampson_error(E, x1[..., None, :, :], x2[..., None, :, :])


def essential_family(
    solver: MinimalSolver = MinimalSolver.NISTER_5PT,
    tables: solvers.SolverTables | None = None,
) -> ModelFamily:
    """Five-point essential family: Nister's closed form (the default) or
    Stewenius's action matrix (EssentialMatEstimator.h:395,463
    fivept_nister / fivept_stewenius)."""
    if solver == MinimalSolver.STEWENIUS_5PT:
        name, solve_5pt = "stewenius", solvers.solve_5pt
    else:
        name, solve_5pt = "nister", solvers.solve_5pt_nister

    def solve(x1, x2):
        return solve_5pt(x1, x2, tables)

    return ModelFamily(f"essential_5pt_{name}", 5, 10, solve,
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
        return solvers.homography_transfer_error(H, x1[..., None, :, :],
                                                 x2[..., None, :, :])

    return ModelFamily("homography_4pt", 4, 1, solve, err)


def fundamental_7pt_family() -> ModelFamily:
    """Fundamental-matrix family (usac FundmatrixEstimator): the 7pt
    minimal solver (3 models per sample) with Sampson scoring."""
    return ModelFamily("fundamental_7pt", 7, 3, solvers.solve_7pt,
                       _sampson_family_error)


def fundamental_8pt_family() -> ModelFamily:
    def solve(x1, x2):
        F, v = solvers.solve_8pt(x1, x2, essential=False)
        return F[:, None], v[:, None]

    return ModelFamily("fundamental_8pt", 8, 1, solve, _sampson_family_error)


def rotation_reproj_error(R, x1, x2):
    """Squared reprojection error of rotation-only motion (..., M, N).

    R: (..., M, 3, 3); x1, x2: (..., N, 2) normalized coords
    (RotationMatEstimator.h residual).
    """
    b1 = geo.normalize_vec(geo.to_homogeneous(x1))
    b1r = torch.einsum("...mij,...nj->...mni", R, b1)
    pr = b1r[..., :2] / torch.clamp(torch.abs(b1r[..., 2:]), min=1e-9) * (
        torch.sign(b1r[..., 2:]))
    return torch.sum((pr - x2[..., None, :, :]) ** 2, dim=-1)


def rotation_only_family() -> ModelFamily:
    """Rotation-only family (usac RotationMatEstimator
    twopt_rotationOnly): the 2pt Horn fit with the rotational
    reprojection error."""

    def solve(x1, x2):
        w = torch.ones(x1.shape[:-1], dtype=x1.dtype, device=x1.device)
        R = rotation_only_model(x1, x2, w)
        v = torch.all(torch.isfinite(R).flatten(-2), dim=-1)
        return R[:, None], v[:, None]

    return ModelFamily("rotation_2pt", 2, 1, solve, rotation_reproj_error)


class RobustResult(NamedTuple):
    # each field carries the inputs' pair axis, if any, in front
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
    """k distinct indices in [0, pool) per row from uniforms u (..., B, k)
    and pool sizes (..., B).

    Shifted-draw scheme: draw r_j in [0, pool - j) and shift it past the
    previously chosen indices in ascending order (exact uniformity, no
    rejection).
    """
    chosen = torch.full(pool_sizes.shape + (k,), n_total + 7,
                        dtype=torch.int64, device=u.device)
    for j in range(k):
        pool_j = torch.clamp(pool_sizes - j, min=1)
        r = torch.minimum((u[..., j] * pool_j).to(torch.int64), pool_j - 1)
        sorted_prev = torch.sort(chosen, dim=-1).values
        for jj in range(k):
            r = torch.where(r >= sorted_prev[..., jj], r + 1, r)
        chosen[..., j] = r
    return chosen


def prosac_pool_schedule(batch_idx: int, n_valid: torch.Tensor,
                         sample_size: int, max_batches: int) -> torch.Tensor:
    """Geometric sampling-pool growth per batch: from ~4x sample_size to
    all valid matches (USAC.h generatePROSACMinSample at batch grain).
    n_valid: valid matches, per pair with a pair axis."""
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


def _score_models(models, mvalid, err_fn, x1, x2, mask, th_sq,
                  lmeds: bool = False):
    """Score (..., M, 3, 3) models: inlier count with an MSAC-style
    truncated error tiebreak, the valid-point count taken per pair; with
    `lmeds`, minus the median residual over the valid points.
    th_sq: () or (...). Returns (score, counts, err)."""
    err = err_fn(models, x1, x2)
    maskf = mask.to(err.dtype)[..., None, :]
    th = th_sq[..., None, None]
    inl = (err < th) & (maskf > 0)
    counts = torch.sum(inl, dim=-1)
    if lmeds:
        score = -geo.masked_median(err, mask[..., None, :].expand(err.shape))
    else:
        trunc = torch.sum(torch.minimum(err, th) * maskf, dim=-1)
        score = counts.to(err.dtype) - trunc / (
            th[..., 0] * (torch.sum(maskf, dim=-1) + 1.0))
    return torch.where(mvalid, score, -torch.inf), counts, err


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def sample_shapes(cfg) -> tuple[tuple[int, int, int], tuple[int, int, int]]:
    """Shapes of one robust call's sample streams for a RobustConfig of
    either package: the E batches' uniforms (max_batches, B, k), k = 8
    for the 8pt solver else 5, and the degeneracy check's single
    homography batch (1, min(B, 64), 4). With a pair axis, each stream
    gains a leading P."""
    B = cfg.batch_hypotheses
    k = 8 if cfg.solver.name == "EIGHT_PT" else 5
    return (cfg.max_batches, B, k), (1, min(B, 64), 4)


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
    active: torch.Tensor | None = None,
) -> RobustResult:
    """Batched robust estimation of one model per correspondence set.

    x1, x2: (N, 2) normalized coords (padded), or (P, N, 2) with a pair
    axis; mask: (..., N) validity; quality: (..., N) higher = better
    (PROSAC order; None = no PROSAC); threshold_sq and prior_inlier_ratio:
    shared or per pair. uniforms: (..., max_batches, B, k) sample
    uniforms, else drawn from `generator`. Every pair runs
    until it meets its stop rule; the loop ends when all have. active:
    (...) bool, the pairs whose result the caller keeps; the others keep
    no batch and hold the loop for none (their model is the identity). LMEDS
    (``cfg.estimator``) keeps the model of least median residual over all
    max_batches (no threshold inflation, no stop, no host read), and its
    inlier band (2.5 * 1.4826 * sqrt(median))^2 becomes the result's
    threshold.
    """
    lmeds = cfg.estimator == PoseEstimator.LMEDS
    dev, dt = x1.device, x1.dtype
    N = x1.shape[-2]
    batch = x1.shape[:-2]
    if threshold_sq is None:
        threshold_sq = cfg.threshold_px ** 2
    th_sq = torch.as_tensor(threshold_sq, dtype=dt, device=dev).expand(batch)
    B = cfg.batch_hypotheses
    k = family.sample_size
    m = family.models_per_sample
    if uniforms is None:
        uniforms = draw_uniforms(generator, batch + (cfg.max_batches, B, k),
                                 dev)

    maskb = mask.to(torch.bool)
    n_valid = torch.sum(maskb.to(torch.int64), dim=-1)
    use_prosac = quality is not None and cfg.prosac
    q = quality.to(dt) if use_prosac else torch.zeros(
        maskb.shape, dtype=dt, device=dev)
    order = torch.argsort(torch.where(maskb, -q, torch.inf), dim=-1,
                          stable=True)

    log_conf = torch.log(_f32(1.0 - cfg.confidence, x1))
    if prior_inlier_ratio is not None:
        eps = torch.clamp(
            torch.as_tensor(prior_inlier_ratio, dtype=torch.float32,
                            device=dev), 0.0, 0.95)
        hyp_needed = log_conf / torch.log1p(
            -torch.clamp(eps**k, 1e-12, 1.0 - 1e-7))

    best_score = torch.full(batch, -torch.inf, dtype=dt, device=dev)
    best_count = torch.zeros(batch, dtype=torch.int64, device=dev)
    best_model = torch.eye(3, dtype=dt, device=dev).expand(batch + (3, 3))
    n_rej = torch.zeros(batch, dtype=torch.int64, device=dev)
    n_batches = torch.zeros(batch, dtype=torch.int64, device=dev)
    # pairs still sampling; one that has stopped keeps its state
    live = torch.ones(batch, dtype=torch.bool, device=dev)
    if active is not None:
        live = live & active
    for i in range(cfg.max_batches):
        # zero-inlier threshold inflation (USAC.h:355-364)
        if cfg.inflate_th_on_failure and not lmeds:
            for at, f in ((cfg.max_batches // 2, 1.33),
                          ((2 * cfg.max_batches) // 3, 1.13)):
                if i == at:
                    th_sq = torch.where(live & (best_count <= k),
                                        th_sq * (f**2), th_sq)
        full = torch.clamp(n_valid, min=k)[..., None]
        if use_prosac:
            # half of every batch samples the full valid pool: the
            # confidence stop assumes full-population draws
            pool = prosac_pool_schedule(i, n_valid, k, cfg.max_batches)
            pool = torch.cat([pool[..., None].expand(batch + (B // 2,)),
                              full.expand(batch + (B - B // 2,))], dim=-1)
        else:
            pool = full.expand(batch + (B,))
        picks = sample_without_replacement(uniforms[..., i, :, :], pool, k, N)
        idx = geo.take_rows(order, picks.reshape(batch + (B * k,)))
        s1 = geo.take_rows(x1, idx).reshape(-1, k, 2)
        s2 = geo.take_rows(x2, idx).reshape(-1, k, 2)
        models, mvalid = family.solve(s1, s2)
        models = models.reshape(batch + (B * m, 3, 3))
        mvalid = mvalid.reshape(batch + (B * m,))
        score, counts, _ = _score_models(
            models, mvalid, family.error, x1, x2, maskb, th_sq, lmeds
        )
        best = torch.argmax(score, dim=-1)[..., None]
        n_rej = n_rej + torch.where(live, torch.sum(~mvalid, dim=-1), 0)
        b_score = torch.gather(score, -1, best)[..., 0]
        better = live & (b_score > best_score)
        best_score = torch.where(better, b_score, best_score)
        best_count = torch.where(better, torch.gather(counts, -1, best)[
            ..., 0], best_count)
        best_model = torch.where(
            better[..., None, None],
            torch.take_along_dim(models, best[..., None, None], dim=-3)[
                ..., 0, :, :],
            best_model)
        n_batches = n_batches + live.to(torch.int64)
        if lmeds:
            # every batch runs: the count is known, nothing to read
            continue
        # adaptive stopping: P(miss) = (1 - w^k)^(hyps so far) < 1 - conf
        n_hyp = _f32((i + 1.0) * B * m, x1)
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
        live = live & ~done
        if not HostSyncs.read(torch.any(live), "ransac", i):
            break

    err = family.error(best_model[..., None, :, :], x1, x2)[..., 0, :]
    if lmeds:
        # robust sigma band (modelest.cpp runLMeDS)
        s = 2.5 * 1.4826 * torch.sqrt(
            torch.clamp(geo.masked_median(err, maskb), min=1e-20))
        th_sq = s * s
    inl = (err < th_sq[..., None]) & maskb
    n_inl = torch.sum(inl, dim=-1)
    ratio = n_inl.to(torch.float32) / torch.clamp(
        n_valid.to(torch.float32), min=1.0)
    n_generated = n_batches * (B * m)
    return RobustResult(
        model=best_model,
        inlier_mask=inl,
        n_inliers=n_inl,
        inlier_ratio=ratio,
        score=best_score,
        threshold=th_sq,
        n_batches=n_batches,
        n_hypotheses=n_generated,
        n_models_generated=n_generated,
        n_models_rejected=n_rej,
        n_points_verified=(n_generated - n_rej) * n_valid,
        n_lo_refinements=torch.zeros(batch, dtype=torch.int64, device=dev),
    )


def _inv_sim(T: torch.Tensor) -> torch.Tensor:
    """Inverse of the similarity [[s, 0, tx], [0, s, ty], [0, 0, 1]]
    (..., 3, 3)."""
    s = T[..., 0, 0]
    z = torch.zeros_like(s)
    o = torch.ones_like(s)
    return torch.stack([
        torch.stack([1.0 / s, z, -T[..., 0, 2] / s], dim=-1),
        torch.stack([z, 1.0 / s, -T[..., 1, 2] / s], dim=-1),
        torch.stack([z, z, o], dim=-1),
    ], dim=-2)


# ---------------------------------------------------------------------------
# local optimization (LOSAC analogue)
# ---------------------------------------------------------------------------


def lo_refine_essential(result: RobustResult, x1, x2, mask,
                        iterations: int = 4,
                        active: torch.Tensor | None = None) -> RobustResult:
    """Iterative pseudo-Huber-weighted 8pt re-fit on the current inliers
    (USAC.h locallyOptimizeSolution); keeps a re-fit only if the inlier
    count does not drop, and stops once a re-fit reproduces the model
    (per pair with a pair axis: a pair that has stopped keeps its model,
    mask and count; a pair not `active` never starts)."""
    th = result.threshold
    batch = x1.shape[:-2]
    maskb = mask.to(torch.bool)
    inl0f = result.inlier_mask.to(x1.dtype)
    x1n, T1 = geo.normalize_points(x1, inl0f)
    x2n, T2 = geo.normalize_points(x2, inl0f)
    A_rows = solvers.epipolar_rows(x1n, x2n)
    T2t = T2.transpose(-1, -2)

    model, inl, n_inl = result.model, result.inlier_mask, result.n_inliers
    n_lo = torch.zeros(batch, dtype=torch.int64, device=x1.device)
    ns_prev = (_inv_sim(T2).transpose(-1, -2) @ result.model
               @ _inv_sim(T1)).reshape(batch + (9,))
    live = torch.ones(batch, dtype=torch.bool, device=x1.device)
    if active is not None:
        live = live & active
    b2 = torch.clamp(th, min=1e-20)[..., None]
    for it in range(iterations):
        err = geo.sampson_error(model, x1, x2)
        w = 1.0 / torch.sqrt(torch.sqrt(1.0 + err / b2))
        w = w * inl.to(w.dtype)
        Aw = A_rows * w[..., None]
        ns = smalllinalg.min_eigvec_spd(Aw.transpose(-1, -2) @ Aw,
                                        iterations=2, v0=ns_prev)
        E_new = T2t @ ns.reshape(batch + (3, 3)) @ T1
        nrm = torch.sqrt(torch.sum(E_new * E_new, dim=(-2, -1)))
        ok = live & torch.isfinite(nrm) & (nrm > 1e-12)
        E_new = torch.where(
            ok[..., None, None],
            E_new / torch.clamp(nrm, min=1e-12)[..., None, None], model)
        inl_new = (geo.sampson_error(E_new, x1, x2) < th[..., None]) & maskb
        n_new = torch.sum(inl_new, dim=-1)
        keep = ok & (n_new >= n_inl)
        d1 = torch.sum((E_new - model) ** 2, dim=(-2, -1))
        d2 = torch.sum((E_new + model) ** 2, dim=(-2, -1))
        done = keep & (torch.minimum(d1, d2) < 1e-14)
        model = torch.where(keep[..., None, None], E_new, model)
        inl = torch.where(keep[..., None], inl_new, inl)
        n_inl = torch.where(keep, n_new, n_inl)
        n_lo = n_lo + keep.to(torch.int64)
        ns_prev = torch.where(ok[..., None], ns, ns_prev)
        live = live & ~done
        if not HostSyncs.read(torch.any(live), "lo", it):
            break
    n_valid = torch.clamp(torch.sum(maskb.to(torch.float32), dim=-1),
                          min=1.0)
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
    (pose_estim.cpp:1983-2130 decision rule). uniforms: (..., 1, Bh, 4)
    for the one-batch homography RANSAC, Bh = min(batch_hypotheses,
    64)."""
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
    rot_inl = (rot_err < th[..., None]) & inl
    rot_frac = torch.sum(rot_inl, dim=-1).to(torch.float32) / n_inl

    static_err = torch.sum((x2 - x1) ** 2, dim=-1)
    static_inl = (static_err < th[..., None]) & inl
    static_frac = torch.sum(static_inl, dim=-1).to(torch.float32) / n_inl

    ratio = cfg.degen_decision_ratio
    is_degen = (h_frac > ratio) | (rot_frac > ratio) | (static_frac > ratio)
    return DegeneracyResult(
        is_degenerate=is_degen, h_fraction=h_frac, rot_fraction=rot_frac,
        static_fraction=static_frac, H=hres.model, R_rotonly=R_ro,
        h_inliers=hres.n_inliers, rot_inliers=torch.sum(rot_inl, dim=-1),
        static_inliers=torch.sum(static_inl, dim=-1),
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
    active: torch.Tensor | None = None,
):
    """Robust E: RANSAC/PROSAC batches + LO refinement + support-guarded
    projection + degeneracy check (estimateEssentialMat,
    pose_estim.cpp:857,1737). Returns (RobustResult, DegeneracyResult |
    None). Takes an optional leading pair axis (``ransac``); active: the
    pairs whose result the caller keeps (the others' loops do not run).

    uniforms: (..., max_batches, B, k) for the E batches; degen_uniforms:
    (..., 1, min(B, 64), 4) for the degeneracy H batch (the JAX package's
    fold_in(key, 777) stream); either, when None, comes from `generator`,
    pair by pair in pair order: the pair's E stream, then its degeneracy
    stream (what as many single-pair calls draw).
    """
    need_degen = cfg.check_degeneracy and degen_uniforms is None
    if x1.ndim == 3 and (uniforms is None or need_degen):
        e_shape, d_shape = sample_shapes(cfg)
        us, ds = [], []
        for _ in range(x1.shape[0]):
            if uniforms is None:
                us.append(draw_uniforms(generator, e_shape, x1.device))
            if need_degen:
                ds.append(draw_uniforms(generator, d_shape, x1.device))
        uniforms = torch.stack(us) if us else uniforms
        degen_uniforms = torch.stack(ds) if ds else degen_uniforms
    if cfg.solver == MinimalSolver.EIGHT_PT:
        family = essential_8pt_family()
    else:
        family = essential_family(cfg.solver, tables)
    res = ransac(family, x1, x2, mask, quality, cfg, threshold_sq,
                 prior_inlier_ratio=prior_inlier_ratio, uniforms=uniforms,
                 generator=generator, active=active)
    if cfg.lo_refine:
        res0 = res
        res = lo_refine_essential(res, x1, x2, mask, cfg.lo_inner_iterations,
                                  active=active)
        # keep the LO outcome only if its PROJECTED support does not fall
        # below the pre-LO support (the raw-DLT chain can drift toward a
        # fundamental-matrix solution), else restore the ransac winner
        E_proj = geo.closest_essential(res.model)
        inl_p = (geo.sampson_error(E_proj, x1, x2)
                 < res.threshold[..., None]) & mask.to(torch.bool)
        n_p = torch.sum(inl_p, dim=-1)
        keep_lo = n_p >= res0.n_inliers
        res = res._replace(
            model=torch.where(keep_lo[..., None, None], E_proj, res0.model),
            inlier_mask=torch.where(keep_lo[..., None], inl_p,
                                    res0.inlier_mask),
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


# ---------------------------------------------------------------------------
# fundamental / rotation-only / no-motion robust estimation + QDEGSAC
# ---------------------------------------------------------------------------


def estimate_fundamental_robust(x1, x2, mask, quality, cfg: RobustConfig,
                                threshold_sq=None, use_8pt: bool = False,
                                uniforms=None, generator=None):
    """Robust fundamental matrix (estimateFundMatrixUsac,
    usac_estimations.cpp:83): the 7pt minimal solver (3 models per
    sample), or the 8pt with `use_8pt`. uniforms: (max_batches, B, 7 or
    8), else drawn from `generator`."""
    fam = fundamental_8pt_family() if use_8pt else fundamental_7pt_family()
    return ransac(fam, x1, x2, mask, quality, cfg, threshold_sq,
                  uniforms=uniforms, generator=generator)


def estimate_nomotion_robust(x1, x2, mask, quality, cfg: RobustConfig,
                             threshold_sq=None) -> RobustResult:
    """No-motion estimation (usac NoMotionEstimator.h): the hypothesis
    space holds one model, the identity motion, whose support is every
    correspondence displaced by less than the threshold; one dense
    scoring pass, no sampling. `quality` is accepted for the menu's
    signature and unused."""
    del quality
    dt, dev = x1.dtype, x1.device
    if threshold_sq is None:
        threshold_sq = cfg.threshold_px ** 2
    th = torch.as_tensor(threshold_sq, dtype=dt, device=dev)
    maskb = mask.to(torch.bool)
    err = torch.sum((x2 - x1) ** 2, dim=-1)
    inl = (err < th) & maskb
    n_inl = torch.sum(inl, dim=-1)
    n_valid = torch.clamp(torch.sum(mask.to(torch.float32), dim=-1),
                          min=1.0)

    def count(v):
        return torch.full(n_inl.shape, v, dtype=torch.int64, device=dev)

    return RobustResult(
        model=torch.eye(3, dtype=dt, device=dev).expand(
            x1.shape[:-2] + (3, 3)),
        inlier_mask=inl,
        n_inliers=n_inl,
        inlier_ratio=n_inl.to(torch.float32) / n_valid,
        # MSAC-style score, comparable with the other families'
        score=torch.sum(torch.where(inl, th - err, 0.0), dim=-1),
        threshold=th,
        n_batches=count(1),
        n_hypotheses=count(1),
        n_models_generated=count(1),
        n_models_rejected=count(0),
        n_points_verified=torch.sum(mask.to(torch.int64), dim=-1),
        n_lo_refinements=count(0),
    )


def estimate_rotation_robust(x1, x2, mask, quality, cfg: RobustConfig,
                             threshold_sq=None, uniforms=None,
                             generator=None) -> RobustResult:
    """Robust rotation-only estimation (estimateRotationMatUsac,
    usac_estimations.cpp:736): 2pt Horn hypotheses, then a Horn re-fit on
    the final inliers that replaces the RANSAC model only on a strict
    gain of inliers with a finite model. uniforms: (max_batches, B, 2),
    else drawn from `generator`."""
    res = ransac(rotation_only_family(), x1, x2, mask, quality, cfg,
                 threshold_sq, uniforms=uniforms, generator=generator)
    R_fit = rotation_only_model(x1, x2, res.inlier_mask.to(x1.dtype))
    err = rotation_reproj_error(R_fit[..., None, :, :], x1, x2)[..., 0, :]
    inl = (err < res.threshold[..., None]) & mask.to(torch.bool)
    n_new = torch.sum(inl, dim=-1)
    # a rank-deficient all-points fit never displaces the RANSAC model on
    # a 0-0 tie
    better = ((n_new > res.n_inliers) & (n_new > 0)
              & torch.all(torch.isfinite(R_fit).flatten(-2), dim=-1))
    n_valid = torch.clamp(torch.sum(mask.to(torch.float32), dim=-1),
                          min=1.0)
    return res._replace(
        model=torch.where(better[..., None, None], R_fit, res.model),
        inlier_mask=torch.where(better[..., None], inl, res.inlier_mask),
        n_inliers=torch.where(better, n_new, res.n_inliers),
        inlier_ratio=torch.where(better, n_new.to(torch.float32) / n_valid,
                                 res.inlier_ratio),
    )


class QdegsacResult(NamedTuple):
    result: RobustResult  # the E estimate (valid when not degenerate)
    F_result: RobustResult  # the unconstrained epipolar-geometry estimate
    R_result: RobustResult  # rotation-only estimate on the F-inliers
    is_degenerate: torch.Tensor  # bool: the scene is rotation-dominated
    rot_fraction: torch.Tensor  # rotation-explained share of F-inliers


def qdegsac_sample_shapes(cfg: RobustConfig):
    """Shapes of QDEGSAC's three streams, in the order the stages draw
    them: F (7pt), rotation (2pt), E (``sample_shapes``)."""
    nb, B = cfg.max_batches, cfg.batch_hypotheses
    return (nb, B, 7), (nb, B, 2), sample_shapes(cfg)[0]


def estimate_essential_qdegsac(x1, x2, mask, quality, cfg: RobustConfig,
                               threshold_sq=None, uniforms=None,
                               generator=None) -> QdegsacResult:
    """QDEGSAC: robust F on the full set, robust rotation-only on the
    F-inliers, the degeneracy decision, then E on the F-inliers
    (estimateEssentialQDEGSAC, usac_estimations.cpp:1162, as dispatched by
    pose_estim.cpp:1983-2130). Rotation-degenerate when the rotation model
    explains more than ``cfg.degen_decision_ratio`` of the F-inliers.

    uniforms: (F, rotation, E) streams of ``qdegsac_sample_shapes`` — the
    JAX package's ``split(key, 3)`` order — else each drawn from
    `generator` as its stage starts.
    """
    u_f, u_r, u_e = uniforms if uniforms is not None else (None,) * 3
    fcfg = dataclasses.replace(cfg, check_degeneracy=False, lo_refine=False)
    fres = ransac(fundamental_7pt_family(), x1, x2, mask, quality, fcfg,
                  threshold_sq, uniforms=u_f, generator=generator)
    rres = estimate_rotation_robust(x1, x2, fres.inlier_mask, quality, fcfg,
                                    threshold_sq, uniforms=u_r,
                                    generator=generator)
    rot_frac = rres.n_inliers.to(torch.float32) / torch.clamp(
        fres.n_inliers.to(torch.float32), min=1.0)
    eres, _ = estimate_essential_robust(
        x1, x2, fres.inlier_mask, quality,
        dataclasses.replace(cfg, check_degeneracy=False), threshold_sq,
        uniforms=u_e, generator=generator)
    return QdegsacResult(
        result=eres, F_result=fres, R_result=rres,
        is_degenerate=rot_frac > cfg.degen_decision_ratio,
        rot_fraction=rot_frac,
    )


# ---------------------------------------------------------------------------
# AutoThEpi: automatic inlier-threshold adaptation
# ---------------------------------------------------------------------------


# AutoTh's rounds (the JAX package's default, which estimate_pose uses)
AUTOTH_ROUNDS = 3


class AutoThResult(NamedTuple):
    result: RobustResult
    degen: DegeneracyResult | None
    threshold: torch.Tensor  # adapted threshold (normalized distance)
    n_rounds: torch.Tensor  # rounds used up to the convergence latch


def estimate_essential_autoth(
    x1: torch.Tensor,
    x2: torch.Tensor,
    mask: torch.Tensor,
    quality: torch.Tensor | None,
    cfg: RobustConfig,
    threshold_sq,
    min_threshold,
    max_threshold,
    rounds: int = AUTOTH_ROUNDS,
    *,
    uniforms: torch.Tensor,
    degen_uniforms: torch.Tensor | None = None,
    tables: solvers.SolverTables | None = None,
) -> AutoThResult:
    """Robust E with automatic threshold adaptation (AutoThEpi,
    pose_estim.cpp:82-300 estimateEVarTH / estimateThresh). Thresholds are
    distances in normalized camera units.

    Each round runs the robust engine (no degeneracy check) at the current
    threshold and re-estimates it from the Sampson distances of all valid
    correspondences below min(4 th, 5 px): median + 3 * 1.4826 MAD when
    mean / median is outside [0.5, 2], else mean + 3 std; a runaway
    estimate (>= 5 th and >= 4 PIX_MIN_GOOD_TH) doubles th instead (or
    resets it to the minimum past half the maximum), clamped to
    [min_threshold, max_threshold]. The round where th moves by < 10% or
    the inlier ratio reaches 0.67 latches the pair's result, threshold
    and round count; the JAX package's later rounds change nothing for
    it, so a latched pair's robust loops do not run again and the rounds
    end once every pair has latched (one host read per round).

    Takes an optional leading pair axis on x1, x2 (P, N, 2), mask and
    quality (P, N), and the thresholds (P,) or shared; every field of the
    result, ``n_rounds`` included, is then per pair.

    uniforms: (..., rounds, max_batches, B, k), round r's E batches (the
    JAX package's r-th ``split`` of the key); degen_uniforms: (..., 1,
    min(B, 64), 4) for the degeneracy check on the latched result (its
    ``fold_in(key, 777)`` of the key left after all rounds), required
    with ``cfg.check_degeneracy`` (ValueError).
    """
    dt, dev = x1.dtype, x1.device
    batch = x1.shape[:-2]
    th = torch.sqrt(torch.as_tensor(threshold_sq, dtype=dt, device=dev))
    th = th.expand(batch)
    min_th = torch.as_tensor(min_threshold, dtype=dt, device=dev)
    max_th = torch.as_tensor(max_threshold, dtype=dt, device=dev)
    # the 5 px trim ceiling and the 4 PIX_MIN_GOOD_TH runaway floor in
    # camera units
    px_unit = min_th / MIN_PIX_TH
    trim_ceiling = 5.0 * px_unit
    runaway_floor = 4.0 * PIX_MIN_GOOD_TH * px_unit
    if cfg.check_degeneracy and degen_uniforms is None:
        raise ValueError("estimate_essential_autoth: check_degeneracy "
                         "needs degen_uniforms")
    round_cfg = dataclasses.replace(cfg, check_degeneracy=False)

    maskb = mask.to(torch.bool)
    frozen = torch.zeros(batch, dtype=torch.bool, device=dev)
    n_rounds = torch.zeros(batch, dtype=torch.int32, device=dev)
    best = None
    for r in range(rounds):
        res, _ = estimate_essential_robust(
            x1, x2, mask, quality, round_cfg, threshold_sq=th * th,
            uniforms=uniforms[..., r, :, :, :], tables=tables,
            active=~frozen)
        err = torch.sqrt(torch.clamp(geo.sampson_error(res.model, x1, x2),
                                     min=0.0))
        max_inl_dist = torch.minimum(4.0 * th, trim_ceiling)
        med, mean, std, mad = geo.masked_stats(
            err, maskb & (err < max_inl_dist[..., None]))
        ratio = mean / torch.clamp(med, min=1e-12)
        th_tmp = torch.where((ratio > 2.0) | (ratio < 0.5),
                             med + 3.0 * (1.4826 * mad), mean + 3.0 * std)
        sane = (th_tmp < 5.0 * th) | (th_tmp < runaway_floor)
        fallback = torch.where(th < 0.5 * max_th, 2.0 * th, min_th)
        th_new = torch.clamp(torch.where(sane, th_tmp, fallback), min_th,
                             max_th)
        # a latched pair keeps its result, threshold and round count
        best = res if best is None else RobustResult(*(
            torch.where(frozen.reshape(frozen.shape + (1,) * (
                old.ndim - frozen.ndim)), old, new)
            for old, new in zip(best, res)))
        n_rounds = torch.where(frozen, n_rounds, r + 1)
        moved = (th / torch.clamp(th_new, min=1e-12) < 0.9) | (
            th_new / torch.clamp(th, min=1e-12) < 0.9)
        converged = ~moved | (res.inlier_ratio >= 0.67)
        th = torch.where(frozen, th, th_new)
        frozen = frozen | converged
        if HostSyncs.read(torch.all(frozen), "auto_th", r):
            break

    degen = None
    if cfg.check_degeneracy:
        degen = analyze_degeneracy(best, x1, x2, mask, cfg,
                                   uniforms=degen_uniforms)
    return AutoThResult(result=best, degen=degen, threshold=th,
                        n_rounds=n_rounds)
