"""Continuous stereo pose refinement: the streaming framework (port of
``models/stereo_refine.py``).

poselib::StereoRefine (stereo_pose_refinement.cpp, configuration
stereo_pose_refinement.h:100-178): per frame, undistort -> inlier check
against the last pose -> robust re-estimation, pool refinement, skip or
reinit by the reference's inlier-ratio thresholds; a correspondence pool
with spatial dedup, weight eviction, outlier removal and triangulated
points (``ops/pool.py``); ranking-based stability detection with the
Sampson-error-range fallback and most-likely-pose persistence;
skip-and-restore with raiseSkipCnt escalation; the RANSAC fallback for
sparse frames; Kneip instead of BA and separate pool-path refine / BA
configs.

Split: the branchy decision logic runs on the host in numpy over a
handful of scalars read from the device (``HostSyncs.fetch``); the pool
and every heavy step (robust batches, IRLS, the LM polish, BA, dedup
distance matrices, eviction sorts) stay on the device across frames.

Randomness: each robust call takes explicit uniforms, from ``streams``
(a callable returning ``(uniforms, degen_uniforms)`` per call, in call
order, where the JAX package splits its key) or else from a
``torch.Generator`` on the device seeded with ``seed``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from matchinglib_poselib_torch.config import (
    PoseEstimator,
    StereoRefineConfig,
)
from matchinglib_poselib_torch.ops import ba, eigensolver
from matchinglib_poselib_torch.ops import geometry as geo
from matchinglib_poselib_torch.ops import pool as poolops
from matchinglib_poselib_torch.ops import refine, robust
from matchinglib_poselib_torch.utils.profiling import HostSyncs

# useRANSAC_fewMatches switches below this many matches
# (stereo_pose_refinement.cpp:1295)
FEW_MATCHES_THRESHOLD = 100
# minimum pool occupancy before stability is evaluated (:3135)
MIN_POOL_SIZE_STABLE = 1000


class FrameResult(NamedTuple):
    """Per-frame output (the reference returns these via getters)."""

    state: str  # init | refined | robust | reinit | skipped | rejected
    R: np.ndarray  # (3, 3) current pose estimate
    t: np.ndarray  # (3,) unit translation
    E: np.ndarray  # (3, 3)
    inlier_ratio: float  # inlier ratio of the new frame vs the pose
    pool_size: int
    pose_is_stable: bool
    most_likely_pose_stable: bool
    R_most_likely: np.ndarray
    t_most_likely: np.ndarray
    skip_count: int


# ---------------------------------------------------------------------------
# device steps
# ---------------------------------------------------------------------------


def _front_depths(R, t, X):
    """Cheirality of triangulated points: both depths positive."""
    z2 = (X @ R.T + t)[:, 2]
    return (X[:, 2] > 0) & (z2 > 0)


def _pose_from_set(
    x1, x2, mask, quality, th_sq, robust_cfg, refine_cfg, ba_cfg,
    kneip_iba: bool, max_dist_z, uniforms, degen_uniforms, sprt_prior=None,
):
    """Robust E + refinement + pose recovery (+ Kneip instead of BA, or
    BA) on one padded correspondence set (robustPoseEstimation,
    stereo_pose_refinement.cpp:1272-1736); far points (z > max_dist_z)
    are left out of BA. sprt_prior: the inlier-ratio prior of the SPRT
    history, which bounds the hypothesis budget. Returns (E, R, t,
    inliers, inlier ratio)."""
    dt = x1.dtype
    res, _ = robust.estimate_essential_robust(
        x1, x2, mask, quality, robust_cfg, threshold_sq=th_sq,
        prior_inlier_ratio=sprt_prior, uniforms=uniforms,
        degen_uniforms=degen_uniforms)
    E = res.model
    inl = res.inlier_mask
    if refine_cfg.enabled:
        rres = refine.refine_essential_linear(E, x1, x2, mask, res.threshold,
                                              refine_cfg)
        keep = rres.n_inliers >= (res.n_inliers // 2)
        E = torch.where(keep, rres.model, E)
        inl = torch.where(keep, rres.inlier_mask, inl)
    R, t, X, ok3d, _ = geo.recover_pose(E, x1, x2, inl.to(dt),
                                        vote_points=512)

    if refine_cfg.polish_rt:
        pol, inl_p = refine.polish_pose_iterative(
            R, t, x1, x2, inl.to(dt), mask.to(dt), res.threshold,
            rounds=refine_cfg.polish_rounds,
            iterations=refine_cfg.polish_iterations,
            max_points=refine_cfg.polish_max_points)
        keep_p = torch.sum(inl_p) >= (torch.sum(inl) * 3) // 4
        R = torch.where(keep_p, pol.R, R)
        t = torch.where(keep_p, pol.t, t)
        E = torch.where(keep_p, pol.E, E)
        inl = torch.where(keep_p, inl_p, inl)
        X = geo.triangulate_linear(R, t, x1, x2)
        ok3d = _front_depths(R, t, X)

    kneip_ok = torch.zeros((), dtype=torch.bool, device=x1.device)
    if kneip_iba:
        kn = eigensolver.refine_essential_kneip(E, x1, x2, inl)
        inl_k = (geo.sampson_error(kn.E, x1, x2) < res.threshold) & (
            mask.to(torch.bool))
        n_k = torch.sum(inl_k)
        kneip_ok = ((n_k >= torch.sum(inl) // 2) & (n_k > 0)
                    & torch.all(torch.isfinite(kn.E)))
        E = torch.where(kneip_ok, kn.E, E)
        R = torch.where(kneip_ok, kn.R, R)
        t = torch.where(kneip_ok, kn.t, t)
        inl = torch.where(kneip_ok, inl_k, inl)
        X = geo.triangulate_linear(R, t, x1, x2)
        ok3d = _front_depths(R, t, X)

    if ba_cfg.enabled:
        ba_mask = inl & ok3d & (X[:, 2] <= max_dist_z)
        eye = torch.eye(3, dtype=dt, device=x1.device)
        bres = ba.refine_stereo_ba(R, t, x1, x2, X, ba_mask.to(dt), eye, eye,
                                   ba_cfg, huber_delta=torch.sqrt(th_sq))
        # when Kneip succeeded it replaces BA (useBA=false, :1633/:1697)
        R = torch.where(kneip_ok, R, bres.R)
        t = torch.where(kneip_ok, t, bres.t)
        E = torch.where(kneip_ok, E, geo.essential_from_rt(bres.R, bres.t))
        inl = torch.where(
            kneip_ok, inl,
            (geo.sampson_error(E, x1, x2) < res.threshold)
            & mask.to(torch.bool))

    n_valid = torch.clamp(torch.sum(mask), min=1.0)
    ratio = torch.sum(inl).to(dt) / n_valid
    return E, R, t, inl, ratio


def _refine_pool_pose(E0, pool: poolops.Pool, th_sq, refine_cfg, ba_cfg,
                      kneip_iba: bool, max_dist_z):
    """Linear refinement of the pose on all pool correspondences with the
    pool-path configs, the LM polish weighted by each slot's aggregated
    quality weight, then Kneip instead of BA or BA (refinePoseFromPool,
    stereo_pose_refinement.cpp:1767-1990). Returns (E, R, t, pool inlier
    ratio)."""
    x1, x2 = pool.x1, pool.x2
    dt = x1.dtype
    maskf = pool.valid.to(dt)
    rres = refine.refine_essential_linear(E0, x1, x2, maskf, th_sq,
                                          refine_cfg)
    E = rres.model
    inl = rres.inlier_mask
    R, t, X, ok3d, _ = geo.recover_pose(E, x1, x2, inl.to(dt))

    if refine_cfg.polish_rt:
        pol, inl_p = refine.polish_pose_iterative(
            R, t, x1, x2, inl.to(dt), maskf, th_sq,
            rounds=refine_cfg.polish_rounds,
            iterations=refine_cfg.polish_iterations,
            max_points=refine_cfg.polish_max_points,
            point_weights=pool.weight)
        keep_p = torch.sum(inl_p) >= (torch.sum(inl) * 3) // 4
        R = torch.where(keep_p, pol.R, R)
        t = torch.where(keep_p, pol.t, t)
        E = torch.where(keep_p, pol.E, E)
        inl = torch.where(keep_p, inl_p, inl)
        X = geo.triangulate_linear(R, t, x1, x2)
        ok3d = _front_depths(R, t, X)

    kneip_ok = torch.zeros((), dtype=torch.bool, device=x1.device)
    if kneip_iba:
        kn = eigensolver.refine_essential_kneip(E, x1, x2, inl)
        inl_k = (geo.sampson_error(kn.E, x1, x2) < th_sq) & pool.valid
        n_k = torch.sum(inl_k)
        kneip_ok = ((n_k >= torch.sum(inl) // 2) & (n_k > 0)
                    & torch.all(torch.isfinite(kn.E)))
        E = torch.where(kneip_ok, kn.E, E)
        R = torch.where(kneip_ok, kn.R, R)
        t = torch.where(kneip_ok, kn.t, t)
        inl = torch.where(kneip_ok, inl_k, inl)
        X = geo.triangulate_linear(R, t, x1, x2)
        ok3d = _front_depths(R, t, X)

    if ba_cfg.enabled:
        ba_mask = inl & ok3d & (X[:, 2] <= max_dist_z)
        eye = torch.eye(3, dtype=dt, device=x1.device)
        bres = ba.refine_stereo_ba(R, t, x1, x2, X, ba_mask.to(dt), eye, eye,
                                   ba_cfg, huber_delta=torch.sqrt(th_sq))
        R = torch.where(kneip_ok, R, bres.R)
        t = torch.where(kneip_ok, t, bres.t)
        E = torch.where(kneip_ok, E, geo.essential_from_rt(bres.R, bres.t))

    inl = (geo.sampson_error(E, x1, x2) < th_sq) & pool.valid
    n_valid = torch.clamp(torch.sum(maskf), min=1.0)
    return E, R, t, torch.sum(inl).to(dt) / n_valid


def _track_frame_pose(E_pool, R_pool, t_pool, pool: poolops.Pool, x1, x2,
                      mask, th_sq, refine_cfg):
    """Adapt the pool pose to the current frame (an extension of the JAX
    package beyond the reference): a rotation-only LM polish on the new
    pair seeded at the pool pose, kept if the frame support does not
    shrink and the pool keeps >= 90% of its inliers; then one full 5-DOF
    round, kept only on a frame-support gain of more than max(2, n / 50)
    under the same pool guard."""
    dt = x1.dtype
    maskb = mask.to(torch.bool)
    poolb = pool.valid

    def pool_support(E):
        return torch.sum(
            (geo.sampson_error(E, pool.x1, pool.x2) < th_sq) & poolb)

    inl0 = (geo.sampson_error(E_pool, x1, x2) < th_sq) & maskb
    pol, inl_p = refine.polish_pose_iterative(
        R_pool, t_pool, x1, x2, inl0.to(dt), mask.to(dt), th_sq, rounds=2,
        iterations=refine_cfg.polish_iterations,
        max_points=refine_cfg.polish_max_points, rotation_only=True)
    n_pool0 = pool_support(E_pool)
    n_poolp = pool_support(pol.E)
    n0 = torch.sum(inl0)
    keep = ((torch.sum(inl_p) >= n0) & (n_poolp >= (n_pool0 * 9) // 10)
            & torch.all(torch.isfinite(pol.E)))
    E = torch.where(keep, pol.E, E_pool)
    R = torch.where(keep, pol.R, R_pool)
    t = torch.where(keep, pol.t, t_pool)
    n_cur = torch.where(keep, torch.sum(inl_p), n0)

    pol5, inl5 = refine.polish_pose_iterative(
        R, t, x1, x2,
        ((geo.sampson_error(E, x1, x2) < th_sq) & maskb).to(dt),
        mask.to(dt), th_sq, rounds=1,
        iterations=refine_cfg.polish_iterations,
        max_points=refine_cfg.polish_max_points)
    n_pool5 = pool_support(pol5.E)
    keep5 = ((torch.sum(inl5) > n_cur + torch.clamp(n_cur // 50, min=2))
             & (n_pool5 >= (n_pool0 * 9) // 10)
             & torch.all(torch.isfinite(pol5.E)))
    E = torch.where(keep5, pol5.E, E)
    R = torch.where(keep5, pol5.R, R)
    t = torch.where(keep5, pol5.t, t)
    return E, R, t


def _frame_inlier_ratio(E, x1, x2, mask, th_sq):
    err = geo.sampson_error(E, x1, x2)
    inl = (err < th_sq) & mask.to(torch.bool)
    n = torch.clamp(torch.sum(mask), min=1.0)
    return torch.sum(inl).to(x1.dtype) / n, inl, err


def _undistort(pts1, pts2, K1, K2, dist1, dist2):
    x1 = geo.undistort_oulu(geo.img_to_cam(pts1, K1), dist1)
    x2 = geo.undistort_oulu(geo.img_to_cam(pts2, K2), dist2)
    return x1, x2


# ---------------------------------------------------------------------------
# the framework
# ---------------------------------------------------------------------------


class StereoRefine:
    """Streaming stereo pose estimator over a fixed camera rig.

    Create once with the calibration, then feed per-frame correspondences
    (numpy arrays or tensors) through ``add_new_correspondences``. Poses
    are relative cam1 -> cam2 with unit translation.

    ``device``: where the pool and the heavy steps live, the CUDA card
    unless the caller asks for the CPU; a CUDA device without a card
    raises. ``streams``: an optional callable returning ``(uniforms
    (max_batches, B, k), degen_uniforms (1, min(B, 64), 4))`` for each
    robust call in call order; without it the uniforms come from a
    ``torch.Generator`` on the device seeded with ``seed``.
    """

    min_pool_size_stable = MIN_POOL_SIZE_STABLE

    def __init__(
        self,
        K1,
        K2,
        dist1=None,
        dist2=None,
        cfg: StereoRefineConfig = StereoRefineConfig(),
        seed: int = 0,
        device: torch.device | str = "cuda",
        streams: Callable[[], tuple] | None = None,
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"StereoRefine(device={str(device)!r}): no CUDA device; "
                "pass device='cpu' to run the plain CPU path")
        self.cfg = cfg
        self.streams = streams
        K1n = np.asarray(K1.cpu() if isinstance(K1, torch.Tensor) else K1)
        K2n = np.asarray(K2.cpu() if isinstance(K2, torch.Tensor) else K2)
        self.K1 = self._dev(K1n)
        self.K2 = self._dev(K2n)
        self.dist1 = self._dev(np.zeros(5) if dist1 is None else dist1)
        self.dist2 = self._dev(np.zeros(5) if dist2 is None else dist2)
        f_mean = float(K1n[0][0] + K1n[1][1] + K2n[0][0] + K2n[1][1]) / 4.0
        th = cfg.pose.robust.threshold_px / f_mean
        self.th_sq = self._dev(th * th)
        # maxDist3DPtsZ is a depth in units of the (unit) baseline
        self.max_dist_z = self._dev(cfg.max_dist_3d_pts_z)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.reset()

    def _dev(self, x) -> torch.Tensor:
        """numpy array, tensor or number -> float32 tensor on the device."""
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=torch.float32)
        return torch.as_tensor(np.asarray(x), dtype=torch.float32,
                               device=self.device)

    # -- state management ---------------------------------------------------

    def reset(self):
        """Full reinitialization (reinitializeSystem / clearHistoryAndPool,
        stereo_pose_refinement.cpp:1025-1070): pool, history, counters."""
        self.pool = poolops.empty_pool(self.cfg.max_pool_correspondences,
                                       self.device)
        self._set_pose(np.zeros((3, 3)), np.eye(3), np.array([1.0, 0.0, 0.0]))
        self.nr_estimation = 0
        self.frame_idx = 0
        self.skip_count = 0
        self.max_skip_pairs_new = self.cfg.max_skip_pairs
        self.pose_history: list[tuple[np.ndarray, np.ndarray]] = []
        self.ratio_history: list[float] = []
        # per-estimation (mean, std) of sqrt-Sampson over new-pair inliers
        # (errorStatistic_history, :858)
        self.err_stat_history: list[tuple[float, float]] = []
        # SPRT (epsilon, delta) history over the last 20 estimations
        # (pose_estim.cpp:1754-1761); its epsilon mean bounds the robust
        # engine's hypothesis budget; cleared on full reinit
        self.sprt_history: list[tuple[float, float]] = []
        self._last_delta = 0.05
        self.pose_ratings: list[float] = []
        self.most_likely_idxs: list[int] = []
        self.pose_is_stable = False
        self.most_likely_pose_stable = False
        self.nr_consec_stable = 0
        self._stability_tries = 0
        self.R_most_likely = np.eye(3)
        self.t_most_likely = np.array([1.0, 0.0, 0.0])
        # checkPoolPoseRobust schedule state (:680-716)
        self._nr_since_robust = 0
        self._check_pool_robust_tmp = max(self.cfg.check_pool_pose_robust, 1)
        self._init_number_inliers = 0
        self._failed_refinements = 0
        self.max_pool_size_reached = False

    def _next_streams(self):
        """(uniforms, degen_uniforms) of the next robust call."""
        if self.streams is not None:
            u, du = self.streams()
            return self._dev(u), self._dev(du)
        return tuple(robust.draw_uniforms(self.generator, s, self.device)
                     for s in robust.sample_shapes(self.cfg.pose.robust))

    def _log(self, msg: str):
        if self.cfg.verbose > 0:
            print(f"[StereoRefine] {msg}")

    def _push_history(self, R, t, ratio: float):
        self.pose_history.append((np.asarray(R), np.asarray(t)))
        self.ratio_history.append(float(ratio))
        if len(self.pose_history) > 100:
            self.pose_history = self.pose_history[-100:]
            self.ratio_history = self.ratio_history[-100:]
            self.err_stat_history = self.err_stat_history[-100:]

    def _set_pose(self, E, R, t):
        """Set the pose from device tensors (one host read brings the
        numpy copies) or from numpy arrays (copied to the device)."""
        if isinstance(E, torch.Tensor):
            self._pose_dev = (E, R, t)
            host = HostSyncs.fetch(torch.cat(
                [E.reshape(9), R.reshape(9), t.reshape(3)]))
            self.E = host[:9].reshape(3, 3)
            self.R = host[9:18].reshape(3, 3)
            self.t = host[18:21]
        else:
            self.E, self.R, self.t = (np.asarray(E), np.asarray(R),
                                      np.asarray(t))
            self._pose_dev = tuple(self._dev(a) for a in (E, R, t))

    def _saved_pose(self):
        return (self.E.copy(), self.R.copy(), self.t.copy(), self._pose_dev)

    def _restore_pose(self, saved):
        self.E, self.R, self.t, self._pose_dev = saved

    # -- sub-steps ----------------------------------------------------------

    def _robust_cfg(self, n_matches: int):
        """useRANSAC_fewMatches (:1295-1323): sparse frames switch the
        robust engine to plain RANSAC for this estimation only."""
        rc = self.cfg.pose.robust
        if (
            self.cfg.use_ransac_few_matches
            and n_matches < FEW_MATCHES_THRESHOLD
            and (rc.estimator != PoseEstimator.RANSAC
                 or self.cfg.pose.auto_th or self.cfg.pose.use_halign)
        ):
            rc = dataclasses.replace(rc, estimator=PoseEstimator.RANSAC,
                                     prosac=False)
        return rc

    def _sprt_prior(self):
        """Inlier-ratio prior from the 20-estimation SPRT history (at least
        3 entries): the epsilon mean less the epsilon and delta spread,
        clipped to [0.05, 0.95]; None before that."""
        if len(self.sprt_history) < 3:
            return None
        eps = np.asarray([e for e, _ in self.sprt_history])
        dlt = np.asarray([d for _, d in self.sprt_history])
        spread = float(np.std(eps) + np.std(dlt))
        prior = float(np.mean(eps)) - spread
        return float(np.clip(prior, 0.05, 0.95))

    def _push_sprt(self, eps: float, delta: float):
        self.sprt_history.append((float(eps), float(delta)))
        if len(self.sprt_history) > 20:
            self.sprt_history = self.sprt_history[-20:]

    def _frame_pose(self, x1, x2, mask, quality, n_matches: int):
        """robustPoseEstimation on the new frame with the per-frame
        configs."""
        prior = self._sprt_prior()
        u, du = self._next_streams()
        out = _pose_from_set(
            x1, x2, mask, quality, self.th_sq, self._robust_cfg(n_matches),
            self.cfg.pose.refine, self.cfg.pose.ba, self.cfg.kneip_instead_ba,
            self.max_dist_z, u, du,
            sprt_prior=None if prior is None else self._dev(prior))
        _, _, _, inl, _ = out
        # delta analogue: share of points that fit the previous pose but
        # not the new one (points a stale model explains)
        if self.nr_estimation > 0:
            err_prev = geo.sampson_error(self._pose_dev[0], x1, x2)
            prev_ok = (err_prev < self.th_sq) & mask.to(torch.bool)
            stale = torch.sum(prev_ok & ~inl)
            s, n = HostSyncs.fetch(torch.stack(
                [stale.to(torch.float32), torch.sum(mask)]))
            self._last_delta = float(s) / max(float(n), 1.0)
        return out

    def _seed_pool(self, pts1, pts2, x1, x2, inl, desc_dist, response):
        """Replace the pool contents with the inliers of a fresh pose."""
        self.pool = poolops.empty_pool(self.cfg.max_pool_correspondences,
                                       self.device)
        err = geo.sampson_error(self._pose_dev[0], x1, x2)
        w = poolops.correspondence_weight(err, desc_dist, response,
                                          self.th_sq)
        self.pool = poolops.insert_and_evict(
            self.pool, pts1, pts2, x1, x2, desc_dist, response, err,
            torch.where(inl, w, 0.0), inl)
        self._init_number_inliers = int(HostSyncs.fetch(torch.sum(inl)))
        self._nr_since_robust = 0
        self._check_pool_robust_tmp = max(self.cfg.check_pool_pose_robust, 1)

    # -- stability detection --------------------------------------------------

    def _get_near_to_mean_pose(self) -> int:
        """getNearToMeanPose (stereo_pose_refinement.cpp:2817-3117).

        Each pose is summarized as the probe point R (0.5, 0.5, 0.5) + t. A
        robust center of gravity comes from per-coordinate outlier
        filtering (mu +- 3 sigma when mean and median agree, the inner
        quartiles otherwise); the pose nearest to it is the most likely
        one (kept while its rating stays within the ranking band of the
        best), and every pose gets the rating 1 - d_i / (d_max + 0.0075
        |CoG|). Returns 0 on success, -1 with < 5 poses, -2 if the poses
        disagree.
        """
        n_p = len(self.pose_history)
        if n_p < 5:
            return -1
        probe = np.array([0.5, 0.5, 0.5])
        pts = np.stack([R @ probe + t for R, t in self.pose_history])

        q0 = int(np.floor(n_p * 0.25 + 0.5))
        q1 = n_p - q0
        order = np.argsort(pts, axis=0)
        sorted_pts = np.take_along_axis(pts, order, axis=0)

        rng = sorted_pts[-1] - sorted_pts[0]
        over_range = bool(np.any(rng > 0.05))
        median = np.median(sorted_pts, axis=0)
        mean_all = pts.mean(axis=0)
        inner = sorted_pts[q0:q1]
        mean_inner = inner.mean(axis=0)
        if over_range:
            std = inner.std(axis=0, ddof=1) if inner.shape[0] > 1 else rng
            center = mean_inner
        else:
            std = pts.std(axis=0, ddof=1) if n_p > 1 else rng
            center = mean_all

        # statFilterPossible: mean and median agree in sign, ratio <= 1.33,
        # difference <= 0.02 (:2965-2984)
        stat_ok = np.zeros(3, bool)
        for i in range(3):
            a, m = mean_all[i], median[i]
            if (a > 0 and m > 0) or (a < 0 and m < 0):
                stat_ok[i] = (max(abs(a / m), abs(m / a)) <= 1.33
                              and abs(a - m) <= 0.02)
            elif abs(a) < 1e-12 or abs(m) < 1e-12:
                stat_ok[i] = abs(a - m) <= 0.02

        def inner_set(i):
            sel = np.zeros(n_p, bool)
            sel[order[q0:q1, i]] = True
            return sel

        valid = np.ones(n_p, bool)
        if not stat_ok.any():
            for i in range(3):
                valid &= inner_set(i)
        else:
            lo = center - 3.0 * std
            hi = center + 3.0 * std
            for i in range(3):
                if stat_ok[i]:
                    valid &= (pts[:, i] > lo[i]) & (pts[:, i] < hi[i])
                else:
                    valid &= inner_set(i)

        if valid.sum() < 3:
            return -2
        cog = pts[valid].mean(axis=0)
        dist = np.linalg.norm(pts - cog, axis=1)
        best = int(np.argmin(dist))
        max_d = dist.max() + np.linalg.norm(cog) * 0.0075
        if self.most_likely_idxs:
            prev = self.most_likely_idxs[-1]
            if (0 <= prev < n_p
                    and (dist[prev] - dist[best]) / max(max_d, 1e-12)
                    <= self.cfg.abs_th_ranking_stable):
                best = prev
        self.R_most_likely = self.pose_history[best][0].copy()
        self.t_most_likely = self.pose_history[best][1].copy()
        self.most_likely_idxs.append(best)
        self.pose_ratings = list(1.0 - dist / max(max_d, 1e-12))
        return 0

    def _check_pose_stability(self):
        """checkPoseStability (stereo_pose_refinement.cpp:3131-3296)."""
        cfg = self.cfg
        err = self._get_near_to_mean_pose()
        if err:
            self.pose_is_stable = False
            self.most_likely_pose_stable = False
            self.R_most_likely = self.R.copy()
            self.t_most_likely = self.t.copy()
            if err != -2:
                self._stability_tries = 0
            return

        n_valid, ratio_far = HostSyncs.fetch(torch.stack(
            [self.pool.n_valid.to(torch.float32),
             poolops.far_point_ratio(self.pool)]))
        n_est = len(self.pose_history)
        if (n_est < cfg.min_cont_stable_poses
                or int(n_valid) < self.min_pool_size_stable):
            self.pose_is_stable = False
            self.most_likely_pose_stable = False
            self._stability_tries = 0
            return

        # ranking-band check over the last minContStablePoses poses (:3158)
        last = self.pose_ratings[-1]
        lo = last - cfg.abs_th_ranking_stable
        hi = last + cfg.abs_th_ranking_stable
        stable = True
        for k in range(2, cfg.min_cont_stable_poses + 1):
            r = self.pose_ratings[n_est - k]
            if not (lo < r < hi and r > cfg.min_norm_dist_stable):
                stable = False
                break

        # most-likely pose persistence (:3178-3203)
        m = cfg.min_cont_stable_poses
        if len(self.most_likely_idxs) >= m:
            last_idx = self.most_likely_idxs[-1]
            same = all(i == last_idx for i in self.most_likely_idxs[-m:])
            self.most_likely_pose_stable = (
                same
                and self.pose_ratings[last_idx] > cfg.min_norm_dist_stable)

        ratio_far = float(ratio_far)
        if stable and ratio_far < 0.95:
            self.pose_is_stable = True
            self.nr_consec_stable += 1
            if self.max_skip_pairs_new <= cfg.max_skip_pairs:
                self._update_max_skip_pairs()
            if self._stability_tries:
                self._stability_tries -= 1
            return

        self.pose_is_stable = False
        self._stability_tries += 1

        # fallback: Sampson-error-range overlap over the last window
        # (:3225-3285) once ranking failed repeatedly, the pool is full
        # and far points do not dominate
        if (self._stability_tries > cfg.min_cont_stable_poses
                and self.max_pool_size_reached
                and ratio_far < cfg.max_rat_3d_pts_far
                and len(self.err_stat_history) >= cfg.min_cont_stable_poses):
            window = self.err_stat_history[-cfg.min_cont_stable_poses:]
            ranges = [(mu - 2.0 * sd, mu + 2.0 * sd) for mu, sd in window]
            mean_error = float(np.mean([mu for mu, _ in window]))
            min_left = min(r[0] for r in ranges)
            min_right = min(r[1] for r in ranges)
            max_left = max(r[0] for r in ranges)
            max_right = max(r[1] for r in ranges)
            if min_right <= min_left or max_left >= max_right:
                self.nr_consec_stable = 0
                return
            span_l = mean_error - min_left
            span_r = max_right - mean_error
            full = span_l + span_r
            if full <= 0:
                self.nr_consec_stable = 0
                return
            pct_l, pct_r = span_l / full, span_r / full
            ok = True
            for left, right in ranges:
                right_ov = pct_r * (right - mean_error) / max(span_r, 1e-12)
                left_ov = pct_l * (mean_error - left) / max(span_l, 1e-12)
                if right_ov + left_ov < 0.8:
                    ok = False
                    break
            if ok:
                self.pose_is_stable = True
                self.nr_consec_stable += 1
            else:
                self.nr_consec_stable = 0
        else:
            self.nr_consec_stable = 0

        if (self.pose_is_stable
                and self.max_skip_pairs_new <= cfg.max_skip_pairs):
            self._update_max_skip_pairs()

    def _update_max_skip_pairs(self):
        """updateMaxSkipPairs (stereo_pose_refinement.cpp:3300-3316):
        raiseSkipCnt low nibble = extra 0.25x factors on maxSkipPairs, high
        nibble + 1 = consecutive stable poses required before raising."""
        cfg = self.cfg
        factor = cfg.raise_skip_cnt & 0xF
        need = ((cfg.raise_skip_cnt & 0xF0) >> 4) + 1
        if factor and need <= self.nr_consec_stable:
            self.max_skip_pairs_new = int(
                np.ceil(cfg.max_skip_pairs * (1.0 + factor * 0.25)))
        else:
            self.max_skip_pairs_new = cfg.max_skip_pairs

    # -- main entry ---------------------------------------------------------

    def add_new_correspondences(
        self, pts1, pts2, mask=None, quality=None, desc_dist=None,
        response=None,
    ) -> FrameResult:
        """Process one frame (addNewCorrespondences,
        stereo_pose_refinement.cpp:416-952). pts1, pts2: (K, 2) pixel
        coords; mask: (K,) validity; quality: (K,) PROSAC quality;
        desc_dist, response: (K,) match and keypoint quality."""
        pts1 = self._dev(pts1)
        pts2 = self._dev(pts2)
        K = pts1.shape[0]

        def col(x, fill):
            if x is None:
                return torch.full((K,), fill, dtype=torch.float32,
                                  device=self.device)
            return self._dev(x)

        mask = col(mask, 1.0)
        quality = col(quality, 1.0)
        desc_dist = col(desc_dist, 0.0)
        response = col(response, 0.0)
        x1, x2 = _undistort(pts1, pts2, self.K1, self.K2, self.dist1,
                            self.dist2)
        self.frame_idx += 1
        n_matches = int(HostSyncs.fetch(torch.sum(mask)))

        step = (self._robust_initialization if self.nr_estimation == 0
                else self._continuous_step)
        result = step(pts1, pts2, x1, x2, mask, quality, desc_dist, response,
                      n_matches)

        if self.skip_count > self.max_skip_pairs_new:
            # too many consecutive bad pairs -> full reinit (:943-948)
            self.reset()
            result = result._replace(state="reinit")
        return result

    # -- state-machine branches ----------------------------------------------

    def _result(self, state: str, ratio: float) -> FrameResult:
        # every accepted estimation feeds the SPRT history; skips and
        # rejections carry no statistics
        if state in ("init", "refined", "robust", "reinit"):
            self._push_sprt(float(ratio), self._last_delta)
        return FrameResult(
            state=state,
            R=self.R.copy(), t=self.t.copy(), E=self.E.copy(),
            inlier_ratio=float(ratio),
            pool_size=int(HostSyncs.fetch(self.pool.n_valid)),
            pose_is_stable=self.pose_is_stable,
            most_likely_pose_stable=self.most_likely_pose_stable,
            R_most_likely=self.R_most_likely.copy(),
            t_most_likely=self.t_most_likely.copy(),
            skip_count=self.skip_count,
        )

    def _robust_initialization(self, pts1, pts2, x1, x2, mask, quality,
                               desc_dist, response, n_matches):
        """robustInitialization (stereo_pose_refinement.cpp:968)."""
        E, R, t, inl, ratio = self._frame_pose(x1, x2, mask, quality,
                                               n_matches)
        ratio_f = float(HostSyncs.fetch(ratio))
        if ratio_f < self.cfg.min_start_agg_inl_rat:
            # not reliable enough to start aggregating (:1015)
            return self._result("rejected", ratio_f)
        self._set_pose(E, R, t)
        self._seed_pool(pts1, pts2, x1, x2, inl, desc_dist, response)
        self.nr_estimation = 1
        self.skip_count = 0
        self._push_history(self.R, self.t, ratio_f)
        self._record_err_stats(x1, x2, mask)
        self._after_accept()
        return self._result("init", ratio_f)

    def _record_err_stats(self, x1, x2, mask):
        """errorStatistic_history entry for the newest pair (:845-858)."""
        err = geo.sampson_error(self._pose_dev[0], x1, x2)
        inl = (err < self.th_sq) & mask.to(torch.bool)
        _, mean, std, _ = geo.masked_stats(
            torch.sqrt(torch.clamp(err, min=0.0)), inl)
        mean, std = HostSyncs.fetch(torch.stack([mean, std]))
        self.err_stat_history.append((float(mean), float(std)))

    def _continuous_step(self, pts1, pts2, x1, x2, mask, quality, desc_dist,
                         response, n_matches):
        cfg = self.cfg
        E_cur = self._pose_dev[0]
        ratio_new, inl_new, err_new = _frame_inlier_ratio(
            E_cur, x1, x2, mask, self.th_sq)
        ratio_new = float(HostSyncs.fetch(ratio_new))
        last_ratio = self.ratio_history[-1]
        frame_ratio = ratio_new

        if ratio_new < (1.0 - cfg.rel_inl_rat_th_last) * last_ratio:
            # significant drop -> robust re-estimation on the new frame
            # (:489)
            E, R, t, inl, ratio_rob = self._frame_pose(x1, x2, mask, quality,
                                                       n_matches)
            ratio_rob_f = float(HostSyncs.fetch(ratio_rob))
            if ratio_new < ratio_rob_f * (1.0 - cfg.rel_inl_rat_th_new):
                # either the pose changed or the pair is bad (:497)
                if (ratio_rob_f >= cfg.min_inlier_ratio_reinit
                        and ratio_new < cfg.min_inlier_ratio_reinit):
                    # the rig moved: reinitialize on the new pose (:501-508)
                    self.reset()
                    self.frame_idx += 1
                    self._set_pose(E, R, t)
                    self._seed_pool(pts1, pts2, x1, x2, inl, desc_dist,
                                    response)
                    self.nr_estimation = 1
                    self._push_history(self.R, self.t, ratio_rob_f)
                    self._record_err_stats(x1, x2, mask)
                    self._log("The pose has changed! System is "
                              "reinitialized!")
                    return self._result("reinit", ratio_rob_f)
                if (ratio_rob_f < cfg.min_inlier_rat_skip
                        and ratio_rob_f
                        < cfg.rel_min_inlier_rat_skip * last_ratio):
                    # bad pair: restore the old pose and skip (:511-521)
                    self.skip_count += 1
                    self._log("Bad image pair: restoring last valid pose")
                    return self._result("skipped", ratio_new)
                # unsure: robust estimation on the pool, keep history, do
                # not add the pair to the pool (:524-558); still counts as
                # a skipped pair (:560)
                self._log("Pose change or bad pair: robust estimation on "
                          "the pool")
                ok = self._robust_on_pool()
                self.skip_count += 1
                if not ok:
                    self.reset()
                    return self._result("reinit", ratio_rob_f)
                self.pose_is_stable = False
                self.most_likely_pose_stable = False
                return self._result("robust", ratio_rob_f)
            # similar pose after re-estimation: a low-quality pair; keep
            # the last pose and add the pair's inliers under it (:563)

        # --- pool insertion + refinement (:594-860) ---
        saved = self._saved_pose()
        w_new = poolops.correspondence_weight(err_new, desc_dist, response,
                                              self.th_sq)
        new_valid, pool_valid, n_found = poolops.filter_new_vs_pool(
            self.pool, pts1, pts2, w_new, inl_new, cfg.min_pts_distance)
        self.pool = self.pool._replace(valid=pool_valid, n_found=n_found)
        self.pool = poolops.insert_and_evict(
            self.pool, pts1, pts2, x1, x2, desc_dist, response, err_new,
            torch.where(new_valid, w_new, 0.0), new_valid)
        pool_size = int(HostSyncs.fetch(self.pool.n_valid))
        if pool_size >= cfg.max_pool_correspondences:
            self.max_pool_size_reached = True

        # robust-vs-refine schedule on the pool (:680-716)
        init_inl = max(self._init_number_inliers, 1)
        run_robust = (
            cfg.check_pool_pose_robust == 1
            or self._nr_since_robust > self._check_pool_robust_tmp
            or (not self.max_pool_size_reached
                and self._check_pool_robust_tmp * init_inl < pool_size))
        min_rel_remaining = 0.75
        if run_robust:
            if not self._robust_on_pool():
                self._restore_pose(saved)
                self.reset()
                return self._result("reinit", frame_ratio)
            if cfg.check_pool_pose_robust > 1:
                # exponential backoff of the robust cadence (:703-713)
                if self.max_pool_size_reached:
                    self._check_pool_robust_tmp = max(
                        cfg.check_pool_pose_robust, 10)
                elif self._check_pool_robust_tmp > 50:
                    self._check_pool_robust_tmp = (
                        cfg.max_pool_correspondences // init_inl + 2)
                else:
                    self._check_pool_robust_tmp = int(round(
                        cfg.check_pool_pose_robust
                        + np.exp(0.8 + self._check_pool_robust_tmp / 6.0)))
            self._nr_since_robust = 0
            min_rel_remaining = 0.7
            if cfg.track_frame_pose:
                self._set_pose(*_track_frame_pose(
                    *self._pose_dev, self.pool, x1, x2, mask, self.th_sq,
                    cfg.refine_pool))
            state = "robust"
        else:
            if self.max_pool_size_reached:
                self._nr_since_robust += 1
            else:
                self._nr_since_robust = 0
            E_p, R_p, t_p, _ = _refine_pool_pose(
                E_cur, self.pool, self.th_sq, cfg.refine_pool, cfg.ba_pool,
                cfg.kneip_instead_ba_pool, self.max_dist_z)
            if not bool(HostSyncs.fetch(torch.all(torch.isfinite(E_p)))):
                # refinement failed: keep the old pose; a second
                # consecutive failure clears the whole system (:725-815)
                self._restore_pose(saved)
                self.skip_count += 1
                if self._failed_refinements > 0:
                    self._failed_refinements = 0
                    self.reset()
                    return self._result("reinit", frame_ratio)
                self._failed_refinements += 1
                return self._result("skipped", frame_ratio)
            self._failed_refinements = 0
            if cfg.track_frame_pose:
                E_p, R_p, t_p = _track_frame_pose(
                    E_p, R_p, t_p, self.pool, x1, x2, mask, self.th_sq,
                    cfg.refine_pool)
            self._set_pose(E_p, R_p, t_p)
            state = "refined"

        # guard (:821-830): too few pool inliers after refinement -> the
        # aggregated state is inconsistent, restore + reinitialize
        E_ref = self._pose_dev[0]
        n_pool_inl, n_pool, _ = poolops.pool_inlier_stats(self.pool, E_ref,
                                                          self.th_sq)
        n_pool_inl, n_pool = HostSyncs.fetch(torch.stack([n_pool_inl,
                                                          n_pool]))
        if float(n_pool_inl) < min_rel_remaining * max(float(n_pool), 1.0):
            self._restore_pose(saved)
            self.reset()
            return self._result("reinit", frame_ratio)

        # guard (:833-845): the refined pose must still explain the new pair
        ratio_ref, _, _ = _frame_inlier_ratio(E_ref, x1, x2, mask,
                                              self.th_sq)
        ratio_ref = float(HostSyncs.fetch(ratio_ref))
        if ratio_ref < frame_ratio * (1.0 - cfg.rel_inl_rat_th_new):
            self._restore_pose(saved)
            self.reset()
            return self._result("reinit", frame_ratio)

        self._push_history(self.R, self.t, ratio_ref)
        self._record_err_stats(x1, x2, mask)
        self.nr_estimation += 1
        self.skip_count = 0
        self._after_accept()
        return self._result(state, ratio_ref)

    def _robust_on_pool(self) -> bool:
        """robustEstimationOnPool (stereo_pose_refinement.cpp:1075): the
        robust engine over the pool with the pool-path refine / BA
        configs."""
        u, du = self._next_streams()
        E, R, t, _, ratio = _pose_from_set(
            self.pool.x1, self.pool.x2, self.pool.valid.to(torch.float32),
            self.pool.weight, self.th_sq, self.cfg.pose.robust,
            self.cfg.refine_pool, self.cfg.ba_pool,
            self.cfg.kneip_instead_ba_pool, self.max_dist_z, u, du)
        finite, ratio = HostSyncs.fetch(torch.stack(
            [torch.all(torch.isfinite(E)).to(torch.float32), ratio]))
        if not finite or float(ratio) <= 0.0:
            return False
        self._set_pose(E, R, t)
        return True

    def _after_accept(self):
        """Post-acceptance housekeeping: pool Sampson-history / 3D update,
        outlier eviction, stability and most-likely pose (:861-940)."""
        E, R, t = self._pose_dev
        self.pool = poolops.evict_outliers(self.pool, E, 4.0 * self.th_sq)
        self.pool = poolops.update_pool_state(self.pool, E, R, t, self.th_sq,
                                              self.max_dist_z)
        self._check_pose_stability()
