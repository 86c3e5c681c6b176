"""Typed configuration tree of the PyTorch port.

Field-for-field mirror of ``matchinglib_poselib_tpu/config.py`` (same
enums, dataclass names, defaults and threshold constants), kept as a
separate module because importing the JAX package imports jax. The three
config layers follow the reference (SURVEY.md §5.6): matching options of
``matchinglib::getCorrespondences`` (matchinglib_correspondences.h:61-78),
the robust-estimation config ``ConfigUSAC`` (poselib/pose_estim.h:94-132)
and the streaming config ``ConfigPoseEstimation``
(stereo_pose_refinement.h:100-176).

Everything is a frozen, hashable Python value; ``convert.config_from_jax``
turns a JAX-package config into its counterpart here.
"""

from __future__ import annotations

import dataclasses
import enum


class PoseEstimator(enum.Enum):
    """Robust estimator menu (reference: pose_estim.h:61-66)."""

    RANSAC = "RANSAC"
    PROSAC = "PROSAC"  # USAC's PROSAC sampling; reference cfg USAC sampling=1
    LMEDS = "LMEDS"
    ARRSAC = "ARRSAC"
    USAC = "USAC"


class MinimalSolver(enum.Enum):
    """Hypothesis solvers (reference: pose_estim.h:67-77 RefineAlg + USAC est.)."""

    NISTER_5PT = "nister"
    STEWENIUS_5PT = "stewenius"
    EIGHT_PT = "8pt"
    HOMOGRAPHY = "homography"
    KNEIP = "kneip"  # rotation eigensolver (opengv eigensolver rows)


class RefineWeights(enum.Enum):
    """Weighting for linear refinement (reference: pose_estim.h:78-84)."""

    SQUARED = "squared"  # plain least squares
    TORR = "torr"
    PSEUDO_HUBER = "pseudohuber"


# Pixel inlier-threshold constants (reference: pose_estim.h:56-59).
PIX_MIN_GOOD_TH = 0.8
PIX_TH_START = 0.8
MIN_PIX_TH = 0.25
MAX_PIX_TH = 2.0

# Lowe ratio used throughout the reference (ratioMatches_Flann.cpp:77).
LOWE_RATIO = 0.75


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """Keypoint detection (reference: features.cpp:145-379,506-770).

    ``max_keypoints`` plays the role of the reference's ``limitNrfeatures``
    with grid-based response filtering (responseFilterGridBased,
    features.cpp:506): we keep the strongest response per spatial grid cell.
    """

    # any name of features.DETECTOR_ALIASES (ORB and BRISK run the
    # pyramid detector with pyramid_levels > 1)
    kind: str = "FAST"
    max_keypoints: int = 2048  # static array capacity; masked when fewer
    fast_threshold: float = 20.0
    grid_cells: int = 0  # 0 = auto from max_keypoints (adaptive like reference)
    nms_radius: int = 3
    pyramid_levels: int = 1
    pyramid_scale: float = 1.25
    # column-band-grouped grid selection (single-scale corner detectors
    # only; 0 = legacy globally-refilled grid top-k). Bands give every
    # cell an exact quota — the reference's responseFilterGridBased
    # semantics — and group the output by column band, which lets patch
    # extraction contract against a static 128-wide window instead of
    # the full image width (features.extract_patches bands path; the
    # largest MXU op of the fused step shrinks ~11x)
    column_bands: int = 16


@dataclasses.dataclass(frozen=True)
class DescriptorConfig:
    """Descriptor extraction (reference: features.cpp:397-484,849-971)."""

    # any name of features.DESCRIPTOR_ALIASES
    kind: str = "ORB"
    patch_size: int = 31
    oriented: bool = True


@dataclasses.dataclass(frozen=True)
class MatchingConfig:
    """Matcher + filters (reference: matchers.cpp:115-736, correspondences.cpp).

    All ANN backends of the reference (FLANN/NMSLIB/ANNOY/CASHASH) map to the
    exact tiled 2-NN engine — a documented behavioral substitution with
    equal-or-better recall (SURVEY.md §7 stage 6). ``matcher_name`` is kept
    for registry parity with the 20+ reference matcher names.
    """

    matcher_name: str = "GMBSOF"
    ratio_test: bool = True
    ratio: float = LOWE_RATIO
    # reference default is ratio-ONLY: GMbSOF's guided matching uses the
    # ratio test when enabled and falls back to cross-checking only with
    # the ratio test off (match_statOptFlow.cpp:149-156 table), and the
    # NMSLIB/FLANN/ANNOY paths never cross-check (nmslib_matchers.h,
    # matchers.cpp:525-707). Stacking both (old default) cost ~40% of
    # the matches vs the reference workload (PARITY_ACCURACY round 3:
    # 416 vs 694 mean) and a second kNN pass per pair.
    cross_check: bool = False
    # GMS filter (reference: gms.cpp:54-84)
    gms_filter: bool = False
    gms_grid: int = 20
    gms_threshold_factor: float = 6.0
    # SOF statistical-flow filter / guided matching (match_statOptFlow.cpp)
    sof_filter: bool = False
    sof_grid_px: int = 100
    sof_validation_th: float = 0.3
    # AUTOTH (match_statOptFlow.cpp:766-801): adapt the validation threshold
    # to the inlier ratio estimated from the ratio-test distribution
    sof_autoth: bool = True
    # strongest-keypoints-per-cell SOF-field initialization
    # (get_Sparse_KeypointField, match_statOptFlow.cpp:5215). The
    # reference restricts the field to the strongest keypoints to bound
    # its per-seed field-building cost; our field statistics are dense
    # masked reductions where extra seeds are free, and the measured
    # effect of the restriction is purely a recall loss (GMBSOF_EVAL.md:
    # 3478 correct @ 0.939 precision with ALL ratio-test seeds vs 3358 @
    # 0.935 restricted) — so the data-driven default is OFF, a documented
    # divergence from the reference's default
    sof_init_strongest: bool = False
    sof_init_per_cell: int = 32
    # VFC filter (vfc.cpp)
    vfc_filter: bool = False
    # subpixel refinement (matchers.cpp:1085-1398)
    subpix_refine: bool = False


@dataclasses.dataclass(frozen=True)
class RobustConfig:
    """Batched robust estimation engine (replaces RANSAC/ARRSAC/USAC/LMEDS).

    Reference semantics: USAC.h:336-520 hypothesis loop, ConfigUSAC
    (pose_estim.h:94-132). SPRT point-wise early exit is replaced by dense
    batch scoring; adaptive stopping happens between hypothesis *batches*
    inside a ``lax.while_loop`` (SURVEY.md §7 stage 3).
    """

    estimator: PoseEstimator = PoseEstimator.USAC
    solver: MinimalSolver = MinimalSolver.NISTER_5PT
    threshold_px: float = PIX_TH_START  # pixel threshold; divided by focal
    confidence: float = 0.99
    batch_hypotheses: int = 512  # hypotheses solved+scored per device step
    max_batches: int = 8  # upper bound for the while_loop
    prosac: bool = True  # quality-sorted sampling growth
    lo_refine: bool = True  # LOSAC-style inner refinement of the best model
    lo_inner_iterations: int = 4
    # degeneracy families scored alongside E (pose_estim.cpp:1983-2130):
    check_degeneracy: bool = True
    degen_decision_ratio: float = 0.85  # fraction of E-inliers explained
    # threshold inflation on zero inliers (USAC.h:355-364)
    inflate_th_on_failure: bool = True
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class HalignConfig:
    """Pose from multi-plane homography alignment (reference:
    pose_homography.cpp:127/291, HomographyAlignment.cpp)."""

    max_planes: int = 3  # static plane-peeling rounds
    min_plane_inliers: int = 20  # reference MIN_PTS_PLANE semantics
    # require sum of plane strengths (inlier fractions) > 0.5, else the
    # scene is not plane-dominated and Halign reports error -2
    # (estimatePoseHomographies checkPlaneStrength, pose_homography.cpp:243)
    check_plane_strength: bool = True


@dataclasses.dataclass(frozen=True)
class RefinementConfig:
    """Linear IRLS refinement (reference: pose_linear_refinement.cpp:85-640)."""

    enabled: bool = True
    solver: MinimalSolver = MinimalSolver.EIGHT_PT
    weights: RefineWeights = RefineWeights.PSEUDO_HUBER
    # 8 IRLS iterations: KITTI parity metrics are noise-identical from 6
    # up, but the streaming stability detector needs the lower per-frame
    # pose jitter of >=8 (test_stereo_refine stability stream); the
    # fori_loop is a large share of the pose stage, so don't raise idly
    iterations: int = 8
    th_multiplier: float = 2.0  # start threshold = m * th
    # IRLS rounds run on a compaction of the starting band (see
    # refine_essential_linear); None disables
    refine_max_points: int | None = 1024
    inlier_loss_guard: bool = True
    # final (R,t)-manifold Gauss-Newton Sampson polish after pose recovery
    # (the decisive accuracy step on real data: Levenberg-Marquardt over the
    # 5-DOF pose, the TPU equivalent of the reference's nonlinear post-
    # refinement; see refine.polish_pose_sampson)
    polish_rt: bool = True
    # LM converges in well under 6 steps per round from the warm starts the
    # rounds provide (KITTI parity aggregates at 6 match 8..25 iterations
    # to 1e-4 deg; each polish round is a sequential ~40 us/iteration LM
    # chain in the fused step, so don't raise idly)
    polish_iterations: int = 6
    # polish runs on a fixed-size compaction of the support (top slots by
    # weight): LM cost is per-iteration op-latency bound, so shrinking the
    # point set cuts the pose-stage time without accuracy loss (KITTI
    # inlier counts are ~400-800, well under the cap)
    polish_max_points: int = 1024
    # polish/re-selection rounds: the polish converges onto its input
    # inlier set's minimum; re-selecting support from all valid matches
    # under the polished model and re-polishing reaches the joint
    # pose+support fixed point (see refine.polish_pose_iterative — on
    # KITTI, 1 round stops at ~1.3 deg t_ang, 3 rounds reach ~0.42 deg)
    polish_rounds: int = 3


@dataclasses.dataclass(frozen=True)
class BAConfig:
    """Bundle adjustment (reference: BA_driver.h:69-113, pose_estim.cpp:1083)."""

    enabled: bool = False
    iterations: int = 20
    robust: bool = True  # pseudo-Huber cost
    huber_delta: float = 1.0
    fix_intrinsics: bool = True
    # post-BA restore guards (pose_estim.h:239-240)
    angle_thresh_deg: float = 1.25
    t_norm_thresh: float = 0.05


@dataclasses.dataclass(frozen=True)
class PoseConfig:
    """Single-pair pose estimation pipeline config."""

    robust: RobustConfig = RobustConfig()
    refine: RefinementConfig = RefinementConfig()
    ba: BAConfig = BAConfig()
    auto_th: bool = False  # AutoThEpi adaptation (pose_estim.cpp:82-300)
    # Halign: pose via multi-plane homography alignment (poselib-test
    # --Halign; pose_homography.cpp:127)
    use_halign: bool = False
    halign: HalignConfig = HalignConfig()


@dataclasses.dataclass(frozen=True)
class StereoRefineConfig:
    """Continuous stereo refinement (reference: stereo_pose_refinement.h:100-176).

    Field-for-field mirror of ``ConfigPoseEstimation`` where meaningful on
    TPU; the correspondence pool is a fixed-capacity SoA array.
    """

    # pool
    max_pool_correspondences: int = 30000  # :129
    min_pts_distance: float = 3.0  # :128 spatial dedup radius
    # robust-estimation cadence on the pool
    check_pool_pose_robust: int = 3  # :130 (exponential backoff applied)
    # start / skip / reinit thresholds (:117-127)
    min_start_agg_inl_rat: float = 0.2
    rel_inl_rat_th_last: float = 0.35
    rel_inl_rat_th_new: float = 0.2
    min_inlier_rat_skip: float = 0.38
    rel_min_inlier_rat_skip: float = 0.7
    max_skip_pairs: int = 5
    min_inlier_ratio_reinit: float = 0.6
    # stability detection (:131-136, :176-178)
    min_cont_stable_poses: int = 3
    abs_th_ranking_stable: float = 0.075  # ranking band half-width (:132)
    min_norm_dist_stable: float = 0.5  # min normalized CoG distance (:136)
    # raiseSkipCnt bit-packing (:176): low nibble = extra 0.25x factors on
    # maxSkipPairs once stable, high nibble + 1 = consecutive stable poses
    # required before raising
    raise_skip_cnt: int = 0
    # far-3D-point handling (:177-178)
    max_rat_3d_pts_far: float = 0.5
    max_dist_3d_pts_z: float = 50.0
    # RANSAC fallback for sparse frames (:133; .cpp:1295-1323 uses < 100)
    use_ransac_few_matches: bool = False
    # Kneip eigensolver instead of BA (:153/:157)
    kneip_instead_ba: bool = False
    kneip_instead_ba_pool: bool = False
    # pool-path refinement/BA configs (refineMethod_CorrPool/BART_CorrPool,
    # :155-158) — the per-frame path uses pose.refine / pose.ba. The
    # compaction caps are 4x the per-frame defaults: the pool aggregates
    # ~25k correspondences across frames, and the whole point of pool
    # refinement is the sqrt(N) noise-floor advantage over a single
    # frame's ~600 inliers — capping at the per-frame 1024 forfeits it
    refine_pool: RefinementConfig = RefinementConfig(
        refine_max_points=4096, polish_max_points=4096
    )
    # TPU-framework extension (not in the reference): after pool
    # refinement, adapt the pose to the CURRENT frame with a short LM
    # polish seeded at the pool pose (guarded against drift). The pool
    # pose is the mean over the aggregation window and floors at the
    # rig's per-frame jitter radius; tracking closes that gap (see
    # models/stereo_refine._track_frame_pose)
    track_frame_pose: bool = True
    ba_pool: BAConfig = BAConfig()
    verbose: int = 0
    pose: PoseConfig = PoseConfig()
