"""Flagship pipeline: correspondences + relative pose on one image pair
(port of ``models/pipeline.py``).

- get_correspondences == matchinglib::getCorrespondences
  (correspondences.cpp:148-519): detection (FAST, SIFT, SURF) ->
  description (ORB, SIFT, M-SURF) -> ratio-test matching (Hamming or
  squared L2) -> (GMBSOF) SOF field -> radius-guided rematch -> optional
  GMS filter.
- estimate_pose == the poselib-test single-pair flow
  (tests/poselib-test/main.cpp:1461-1560): camera coords, Oulu
  undistortion, robust 5pt E, IRLS refinement, cheirality-voted pose
  recovery, LM Sampson polish.

Outputs are fixed-shape masked tensors on the inputs' device. Branches of
the JAX package that are not ported yet (other detectors and descriptors,
BOLD, SOF-filter/VFC/subpixel filters, Halign, AutoTh, BA, run_batch)
raise NotImplementedError.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from matchinglib_poselib_torch.config import (
    DescriptorConfig,
    DetectorConfig,
    MatchingConfig,
    PoseConfig,
)
from matchinglib_poselib_torch.ops import features, filters
from matchinglib_poselib_torch.ops import geometry as geo
from matchinglib_poselib_torch.ops import matching, refine, robust, solvers
from matchinglib_poselib_torch.utils.profiling import StageTimer


class Correspondences(NamedTuple):
    pts1: torch.Tensor  # (K, 2) pixel coords in image 1
    pts2: torch.Tensor  # (K, 2) matched pixel coords in image 2
    mask: torch.Tensor  # (K,) bool
    quality: torch.Tensor  # (K,) match quality (higher = better)
    distance: torch.Tensor  # (K,) descriptor distance
    kps1: features.Keypoints
    kps2: features.Keypoints

    @property
    def n(self):
        return torch.sum(self.mask.to(torch.int32))


class PoseResult(NamedTuple):
    R: torch.Tensor  # (3, 3) rotation cam1 -> cam2
    t: torch.Tensor  # (3,) unit translation
    E: torch.Tensor  # (3, 3) essential matrix
    inlier_mask: torch.Tensor  # (K,) bool over correspondences
    n_inliers: torch.Tensor
    inlier_ratio: torch.Tensor
    points3d: torch.Tensor  # (K, 3) triangulated points (camera-1 frame)
    valid3d: torch.Tensor  # (K,) cheirality mask
    is_degenerate: torch.Tensor  # bool flag from degeneracy analysis
    n_models_generated: torch.Tensor | int = 0
    n_models_rejected: torch.Tensor | int = 0
    n_points_verified: torch.Tensor | int = 0
    n_lo_refinements: torch.Tensor | int = 0
    halign_error_code: torch.Tensor | int = 0


def _stage(timer: StageTimer | None, name: str):
    return timer.stage(name) if timer is not None else contextlib.nullcontext(
        {})


def get_correspondences(
    img1: torch.Tensor,
    img2: torch.Tensor,
    det_cfg: DetectorConfig = DetectorConfig(),
    desc_cfg: DescriptorConfig = DescriptorConfig(),
    match_cfg: MatchingConfig = MatchingConfig(),
    shape: tuple[int, int] | None = None,
    timer: StageTimer | None = None,
    tables: features.DescriptorTables | None = None,
) -> Correspondences:
    """Full correspondence pipeline on one image pair.

    img1, img2: (H, W) float32 grayscale in [0, 1]. timer: optional
    StageTimer charged with keypoints / descriptors / matching.
    """
    unported = [name for name, on in (
        ("sof_filter", match_cfg.sof_filter
         and match_cfg.matcher_name.upper() != "GMBSOF"),
        ("subpix_refine", match_cfg.subpix_refine),
        ("vfc_filter", match_cfg.vfc_filter),
    ) if on]
    if unported:
        raise NotImplementedError(f"not ported yet: {', '.join(unported)}")
    if shape is None:
        shape = tuple(img1.shape)
    binary = features.is_binary_descriptor(desc_cfg.kind)
    # ratio test when enabled, cross-checking as the fallback without it
    # (match_statOptFlow.cpp:149-156)
    cross = match_cfg.cross_check or not match_cfg.ratio_test
    bands = features.detector_bands(det_cfg)

    with _stage(timer, "keypoints") as h:
        kps1 = features.detect_keypoints(img1, det_cfg)
        kps2 = features.detect_keypoints(img2, det_cfg)
        h["outputs"] = (kps1, kps2)
    with _stage(timer, "descriptors") as h:
        d1, kps1 = features.compute_descriptors(img1, kps1, desc_cfg, bands,
                                                tables)
        d2, kps2 = features.compute_descriptors(img2, kps2, desc_cfg, bands,
                                                tables)
        h["outputs"] = (d1, d2)
    with _stage(timer, "matching") as h:
        res = matching.match_descriptors(
            d1, d2, kps1.mask, kps2.mask, binary=binary,
            ratio_test=match_cfg.ratio_test, ratio=match_cfg.ratio,
            cross_check=cross,
        )
        pts1 = kps1.xy
        pts2 = kps2.xy[res.idx.long()]
        mask = res.mask
        if match_cfg.matcher_name.upper() == "GMBSOF":
            cell_px = match_cfg.sof_grid_px
            init_mask = mask
            if match_cfg.sof_init_strongest:
                init_mask = mask & filters.select_strongest_per_cell(
                    kps1.xy, kps1.score, kps1.mask, shape, cell_px=cell_px,
                    per_cell=match_cfg.sof_init_per_cell,
                )
            if match_cfg.sof_autoth:
                vth = filters.autoth_validation_th(
                    matching.estimate_inlier_ratio_from_ratios(res), binary
                )
            else:
                vth = match_cfg.sof_validation_th
            field = filters.sof_statistics(
                pts1, pts2, init_mask, shape, cell_px=cell_px,
                validation_th=vth,
            )
            pred, rad = filters.sof_predict(field, kps1.xy, cell_px)
            # sparse-seed fallback where the query's cell never validated
            predk, radk, okk = filters.sof_predict_knn(
                pts1, pts2 - pts1, init_mask, kps1.xy
            )
            use_knn = ~filters.sof_cell_valid_at(field, kps1.xy, cell_px) & okk
            pred = torch.where(use_knn[:, None], predk, pred)
            rad = torch.where(use_knn, radk, rad)
            res = matching.match_descriptors(
                d1, d2, kps1.mask, kps2.mask, binary=binary,
                ratio_test=match_cfg.ratio_test, ratio=match_cfg.ratio,
                cross_check=cross, guide_pred=pred, guide_rad=rad,
                pts2_xy=kps2.xy,
            )
            pts2 = kps2.xy[res.idx.long()]
            mask = res.mask
        if match_cfg.gms_filter:
            mask = filters.gms_filter(
                pts1, pts2, mask, shape, shape, grid=match_cfg.gms_grid,
                alpha=match_cfg.gms_threshold_factor,
            )
        # PROSAC quality: inverse distance ratio
        ratio_q = res.distance / torch.clamp(res.second_distance, min=1e-9)
        quality = torch.where(mask, 1.0 - ratio_q, 0.0)
        h["outputs"] = (pts2, quality)
    return Correspondences(
        pts1=pts1, pts2=pts2, mask=mask, quality=quality,
        distance=res.distance, kps1=kps1, kps2=kps2,
    )


def estimate_pose(
    pts1: torch.Tensor,
    pts2: torch.Tensor,
    mask: torch.Tensor,
    quality: torch.Tensor,
    K1: torch.Tensor,
    K2: torch.Tensor,
    dist1: torch.Tensor,
    dist2: torch.Tensor,
    cfg: PoseConfig = PoseConfig(),
    generator: torch.Generator | None = None,
    uniforms: torch.Tensor | None = None,
    degen_uniforms: torch.Tensor | None = None,
    tables: solvers.SolverTables | None = None,
) -> PoseResult:
    """Robust relative pose from pixel correspondences (default branch).

    The pixel threshold becomes normalized units via the mean focal length
    (pose_estim.cpp th2 = th / ((fx1+fy1+fx2+fy2)/4)). Sample uniforms come
    from `uniforms` / `degen_uniforms` (see robust.estimate_essential_robust)
    or from `generator`.
    """
    unported = [name for name, on in (
        ("use_halign", cfg.use_halign), ("auto_th", cfg.auto_th),
        ("ba.enabled", cfg.ba.enabled),
    ) if on]
    if unported:
        raise NotImplementedError(f"not ported yet: {', '.join(unported)}")
    maskf = mask.to(torch.float32)
    x1 = geo.undistort_oulu(geo.img_to_cam(pts1, K1), dist1)
    x2 = geo.undistort_oulu(geo.img_to_cam(pts2, K2), dist2)
    f_mean = 0.25 * (K1[0, 0] + K1[1, 1] + K2[0, 0] + K2[1, 1])
    th = cfg.robust.threshold_px / f_mean
    th_sq = th * th

    # SPRT-init parity (pose_estim.cpp:1814-1940): the match-quality
    # distribution bounds the hypothesis budget
    n_val = torch.clamp(torch.sum(maskf), min=1.0)
    prior = torch.clamp(
        torch.sum(((quality > 0.4) & mask.to(torch.bool)).to(torch.float32))
        / n_val, 0.05, 0.95,
    )
    res, degen = robust.estimate_essential_robust(
        x1, x2, maskf, quality, cfg.robust, threshold_sq=th_sq,
        prior_inlier_ratio=prior, uniforms=uniforms,
        degen_uniforms=degen_uniforms, generator=generator, tables=tables,
    )
    E = res.model
    inl = res.inlier_mask
    degen_flag = (degen.is_degenerate if degen is not None
                  else torch.zeros((), dtype=torch.bool, device=x1.device))

    if cfg.refine.enabled:
        rres = refine.refine_essential_linear(
            E, x1, x2, maskf, res.threshold, cfg.refine
        )
        # inlier-loss guard of the reference's refinement call sites
        keep = rres.n_inliers >= (res.n_inliers // 2)
        E = torch.where(keep, rres.model, E)
        inl = torch.where(keep, rres.inlier_mask, inl)

    R, t, X, ok3d, _ = geo.recover_pose(E, x1, x2, inl.to(torch.float32),
                                        vote_points=512)
    if cfg.refine.polish_rt:
        pol, inl_p = refine.polish_pose_iterative(
            R, t, x1, x2, inl.to(torch.float32), maskf, res.threshold,
            rounds=cfg.refine.polish_rounds,
            iterations=cfg.refine.polish_iterations,
            max_points=cfg.refine.polish_max_points,
        )
        keep = torch.sum(inl_p) >= (torch.sum(inl) * 3) // 4
        R = torch.where(keep, pol.R, R)
        t = torch.where(keep, pol.t, t)
        E = torch.where(keep, pol.E, E)
        inl = torch.where(keep, inl_p, inl)
        _, X, ok3d = geo.cheirality_counts(R, t, x1, x2, inl)

    n_inl = torch.sum(inl)
    return PoseResult(
        R=R, t=t, E=E, inlier_mask=inl, n_inliers=n_inl,
        inlier_ratio=n_inl.to(torch.float32) / n_val,
        points3d=X, valid3d=ok3d, is_degenerate=degen_flag,
        n_models_generated=res.n_models_generated,
        n_models_rejected=res.n_models_rejected,
        n_points_verified=res.n_points_verified,
        n_lo_refinements=res.n_lo_refinements,
        halign_error_code=torch.zeros((), dtype=torch.int32,
                                      device=x1.device),
    )


class StereoPipeline:
    """Detect + describe + match + pose on a stereo pair.

    Owns the configs and a StageTimer with the reference's stage names;
    ``run`` executes the pipeline on one pair. ``run_batch`` of the JAX
    package is not ported yet.

    ``device``: where the pipeline runs, the CUDA card unless the caller
    asks for the CPU. ``run`` and ``correspondences`` move their inputs
    (numpy arrays or tensors) there; a ``generator`` must live there too.
    A CUDA device without a card raises: there is no fallback to the CPU.
    """

    def __init__(
        self,
        det_cfg: DetectorConfig = DetectorConfig(),
        desc_cfg: DescriptorConfig = DescriptorConfig(),
        match_cfg: MatchingConfig = MatchingConfig(),
        pose_cfg: PoseConfig = PoseConfig(),
        verbose: int = 0,
        descriptor_tables: features.DescriptorTables | None = None,
        solver_tables: solvers.SolverTables | None = None,
        device: torch.device | str = "cuda",
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"StereoPipeline(device={str(device)!r}): no CUDA device; "
                "pass device='cpu' to run the plain CPU path")
        self.det_cfg = det_cfg
        self.desc_cfg = desc_cfg
        self.match_cfg = match_cfg
        self.pose_cfg = pose_cfg
        self.descriptor_tables = descriptor_tables
        self.solver_tables = solver_tables
        self.timer = StageTimer(verbose=verbose)

    def _to(self, x):
        """numpy array or tensor -> tensor on the pipeline's device
        (floating point as float32)."""
        if x is None:
            return None
        x = torch.as_tensor(x, device=self.device)
        return x.to(torch.float32) if x.is_floating_point() else x

    def correspondences(self, img1, img2) -> Correspondences:
        return get_correspondences(
            self._to(img1), self._to(img2), self.det_cfg, self.desc_cfg,
            self.match_cfg, timer=self.timer, tables=self.descriptor_tables,
        )

    def run(self, img1, img2, K1, K2, dist1, dist2,
            generator: torch.Generator | None = None,
            uniforms: torch.Tensor | None = None,
            degen_uniforms: torch.Tensor | None = None) -> tuple:
        corr = self.correspondences(img1, img2)
        with self.timer.stage("robEstimationAndRef") as h:
            pose = estimate_pose(
                corr.pts1, corr.pts2, corr.mask, corr.quality,
                self._to(K1), self._to(K2), self._to(dist1),
                self._to(dist2), self.pose_cfg, generator=generator,
                uniforms=self._to(uniforms),
                degen_uniforms=self._to(degen_uniforms),
                tables=self.solver_tables,
            )
            h["outputs"] = pose
        return corr, pose
