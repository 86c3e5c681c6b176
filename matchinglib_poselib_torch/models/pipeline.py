"""Flagship pipeline: correspondences + relative pose on one image pair
(port of ``models/pipeline.py``).

- get_correspondences == matchinglib::getCorrespondences
  (correspondences.cpp:148-519): detection (every detector row of
  ``features.DETECTOR_ALIASES``) -> description (every descriptor row of
  ``features.DESCRIPTOR_ALIASES``) -> ratio-test matching (Hamming or
  squared L2; BOLD's masked Hamming, ``descriptors_ext.match_bold``) ->
  (GMBSOF) SOF field -> radius-guided rematch (BOLD: the SOF consistency
  filter of the first-pass matches instead) -> the optional filters in
  the JAX package's order: GMS, the SOF consistency filter (a matcher
  other than GMBSOF), sub-pixel refinement of pts2, VFC.
- estimate_pose == the poselib-test single-pair flow
  (tests/poselib-test/main.cpp:1461-1560): camera coords, Oulu
  undistortion, robust 5pt E (or --autoTH's adaptive threshold, or
  --Halign's multi-plane homography pose with the robust-E fallback), IRLS
  refinement (optionally the Kneip eigensolver polish), cheirality-voted
  pose recovery, LM Sampson polish, optional stereo BA (--BART).

- StereoPipeline.run_batch == the JAX package's ``run_batch`` (``jax.vmap``
  of the whole program over a pair axis): one fused FAST+NMS call for
  every image of the batch on the single-scale FAST rows (the other
  detector rows image by image), descriptors and matching pair by pair,
  then one ``estimate_pose`` over the pair axis (every PoseConfig
  branch).

Outputs are fixed-shape masked tensors on the inputs' device.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import NamedTuple

import torch

from matchinglib_poselib_torch.config import (
    MAX_PIX_TH,
    MIN_PIX_TH,
    DescriptorConfig,
    DetectorConfig,
    MatchingConfig,
    PoseConfig,
)
from matchinglib_poselib_torch.ops import features, filters
from matchinglib_poselib_torch.ops import geometry as geo
from matchinglib_poselib_torch.ops import (
    ba, homography_pose, matching, refine, robust, solvers, subpix,
)
from matchinglib_poselib_torch.utils.profiling import HostSyncs, StageTimer


class Correspondences(NamedTuple):
    # run_batch puts a leading pair axis P in front of every field
    pts1: torch.Tensor  # (K, 2) pixel coords in image 1
    pts2: torch.Tensor  # (K, 2) matched pixel coords in image 2
    mask: torch.Tensor  # (K,) bool
    quality: torch.Tensor  # (K,) match quality (higher = better)
    distance: torch.Tensor  # (K,) descriptor distance
    kps1: features.Keypoints
    kps2: features.Keypoints

    @property
    def n(self):
        """Correspondences (per pair with a pair axis)."""
        return torch.sum(self.mask.to(torch.int32), dim=-1)


class PoseResult(NamedTuple):
    # estimate_pose with a pair axis puts P in front of every field
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


def _match(img1, img2, d1, d2, kps1, kps2, binary: bool,
           match_cfg: MatchingConfig, shape: tuple[int, int],
           bold: bool = False) -> Correspondences:
    """Ratio-test matching, the GMBSOF guided rematch and the filter chain
    on one pair's descriptors (the images for sub-pixel refinement).
    `bold`: the descriptors are BOLD's (K, 32) words, bits then stability
    mask, matched by the masked Hamming distance."""
    # ratio test when enabled, cross-checking as the fallback without it
    # (match_statOptFlow.cpp:149-156)
    cross = match_cfg.cross_check or not match_cfg.ratio_test
    gmbsof = match_cfg.matcher_name.upper() == "GMBSOF"
    if bold:
        from matchinglib_poselib_torch.ops import descriptors_ext

        res = descriptors_ext.match_bold(
            d1[:, :16], d1[:, 16:], d2[:, :16], d2[:, 16:], kps1.mask,
            kps2.mask, ratio_test=match_cfg.ratio_test,
            ratio=match_cfg.ratio, cross_check=cross)
    else:
        res = matching.match_descriptors(
            d1, d2, kps1.mask, kps2.mask, binary=binary,
            ratio_test=match_cfg.ratio_test, ratio=match_cfg.ratio,
            cross_check=cross,
        )
    pts1 = kps1.xy
    pts2 = kps2.xy[res.idx.long()]
    mask = res.mask
    if gmbsof and bold:
        # no guided BOLD rematch: the SOF consistency filter of the
        # first-pass matches instead
        mask = filters.sof_filter_matches(
            pts1, pts2, mask, shape, cell_px=match_cfg.sof_grid_px,
            validation_th=match_cfg.sof_validation_th)
    elif gmbsof:
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
    if match_cfg.sof_filter and not gmbsof:
        mask = filters.sof_filter_matches(
            pts1, pts2, mask, shape, cell_px=match_cfg.sof_grid_px,
            validation_th=match_cfg.sof_validation_th,
        )
    if match_cfg.subpix_refine:
        # template-matching refinement of the right-image points
        # (getSubPixMatches, matchers.cpp:1085)
        pts2 = subpix.refine_matches_subpix(img1, img2, pts1, pts2,
                                            mask).pts2
    if match_cfg.vfc_filter:
        mask = filters.vfc_filter(filters.to_unit(pts1, shape),
                                  filters.to_unit(pts2, shape),
                                  mask).inlier_mask
    # PROSAC quality: inverse distance ratio
    ratio_q = res.distance / torch.clamp(res.second_distance, min=1e-9)
    quality = torch.where(mask, 1.0 - ratio_q, 0.0)
    return Correspondences(
        pts1=pts1, pts2=pts2, mask=mask, quality=quality,
        distance=res.distance, kps1=kps1, kps2=kps2,
    )


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
    if shape is None:
        shape = tuple(img1.shape)
    binary = features.is_binary_descriptor(desc_cfg.kind)
    bold = features.is_bold_descriptor(desc_cfg.kind)
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
        corr = _match(img1, img2, d1, d2, kps1, kps2, binary, match_cfg,
                      shape, bold)
        h["outputs"] = (corr.pts2, corr.quality)
    return corr


def _check_shapes(where: str, pairs) -> None:
    """ValueError unless each (name, tensor or None, shape) has its
    shape."""
    for name, x, shape in pairs:
        if x is not None and tuple(x.shape) != tuple(shape):
            raise ValueError(f"{where}: {name} has shape {tuple(x.shape)}, "
                             f"expected {tuple(shape)}")


def _stream_shapes(where: str, cfg: PoseConfig, P: int, uniforms=None,
                   degen_uniforms=None, plane_uniforms=None):
    """[(name, stream, its shape for P pairs)] of the streams cfg's branch
    draws, in the order a generator draws them for one pair: plane
    streams, E streams (Halign's robust-E fallback's, AutoTh's rounds'),
    degeneracy stream. ValueError, before any work, for a stream given
    with the wrong shape or one the branch does not take: Halign's
    degeneracy stream (its fallback's degeneracy result is discarded),
    the plane streams off Halign. With ``check_degeneracy`` off the
    degeneracy stream is not drawn; one given is checked and unused."""
    e_shape, d_shape = robust.sample_shapes(cfg.robust)
    degen = ("degen_uniforms", degen_uniforms, (P, *d_shape))
    if cfg.use_halign:
        foreign = "degen_uniforms", degen_uniforms
        drawn = [("plane_uniforms", plane_uniforms,
                  (P, cfg.halign.max_planes, *e_shape[:2], 4)),
                 ("uniforms", uniforms, (P, *e_shape))]
    else:
        foreign = "plane_uniforms", plane_uniforms
        if cfg.auto_th:
            e_shape = (robust.AUTOTH_ROUNDS, *e_shape)
        drawn = [("uniforms", uniforms, (P, *e_shape))]
        if cfg.robust.check_degeneracy:
            drawn.append(degen)
        else:
            _check_shapes(where, [degen])
    if foreign[1] is not None:
        raise ValueError(f"{where}: this PoseConfig takes no {foreign[0]}")
    _check_shapes(where, drawn)
    return drawn


def _streams(cfg: PoseConfig, P: int, generator, device, **given) -> dict:
    """Every sample stream of cfg's branch for P pairs: those given
    (checked by ``_stream_shapes`` before any work), the others drawn
    from `generator` up front, pair by pair in ``_stream_shapes``' order —
    what as many single-pair calls draw from the same generator, Halign's
    fallback streams whether the fallback runs or not."""
    shapes = _stream_shapes("estimate_pose", cfg, P, **given)
    missing = [(name, shape[1:]) for name, x, shape in shapes if x is None]
    drawn = [[robust.draw_uniforms(generator, shape, device)
              for _, shape in missing] for _ in range(P)]
    out = {name: x for name, x, _ in shapes}
    for k, (name, _) in enumerate(missing):
        out[name] = torch.stack([d[k] for d in drawn])
    return out


def _stack(items):
    """Per-pair results (tensors or NamedTuples of them, nested) stacked
    on a new leading pair axis."""
    if isinstance(items[0], torch.Tensor):
        return torch.stack(items)
    return type(items[0])(*(_stack(list(f)) for f in zip(*items)))


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
    plane_uniforms: torch.Tensor | None = None,
) -> PoseResult:
    """Robust relative pose from pixel correspondences.

    The pixel threshold becomes normalized units via the mean focal length
    (pose_estim.cpp th2 = th / ((fx1+fy1+fx2+fy2)/4)). Branches, as in the
    JAX package: robust E (default), AutoTh (``cfg.auto_th``) or Halign
    (``cfg.use_halign``, the robust-E fallback when it reports an error);
    then IRLS refinement (Kneip polish with ``solver=KNEIP``), pose
    recovery, the LM Sampson polish and stereo BA (``cfg.ba.enabled``).

    Pair axis: pts1, pts2 (P, K, 2), mask and quality (P, K) with shared
    K1, K2, dist1, dist2 give a PoseResult with a leading P, pair i equal
    to the call on pair i with pair i's streams (``jax.vmap`` of the JAX
    package's function: the loops run until every pair has exited, each
    pair keeps its state from its own exit), for every branch. A single
    pair runs as a batch of one.

    Sample uniforms, each the counterpart of one JAX key stream (k = 5, or
    8 for the 8pt solver; B = cfg.robust.batch_hypotheses), with a leading
    P for a pair axis (pair i from the i-th ``split`` of the JAX key):

    - default: ``uniforms`` (max_batches, B, k); ``degen_uniforms``
      (1, min(B, 64), 4) for the degeneracy check (``fold_in(key, 777)``);
    - AutoTh: ``uniforms`` (3 rounds, max_batches, B, k), round r from the
      r-th ``split`` of the key; ``degen_uniforms`` from ``fold_in`` of the
      key left after the rounds;
    - Halign: ``plane_uniforms`` (max_planes, max_batches, B, 4), plane r
      from the r-th ``split`` of Halign's key; ``uniforms`` (max_batches,
      B, k) for the robust-E fallback (the key's first ``split``).

    A stream that is None is drawn from ``generator`` before any work,
    pair by pair, each pair's in the order plane streams, E streams (the
    Halign fallback's whether it runs or not), degeneracy stream: what as
    many single-pair calls draw from the same generator. A stream of the
    wrong shape, or one the branch does not take (``degen_uniforms`` with
    Halign, ``plane_uniforms`` without), raises ValueError.
    """
    if mask.ndim == 1:
        # one pair is a batch of one: the arithmetic of each pair of a
        # batch, to the bit where the device's batched products are
        # independent of the batch size
        def one(x):
            return None if x is None else x[None]

        pose = estimate_pose(
            pts1[None], pts2[None], mask[None], quality[None], K1, K2, dist1,
            dist2, cfg, generator, one(uniforms), one(degen_uniforms),
            tables, one(plane_uniforms))
        return PoseResult(*(f[0] for f in pose))
    P, K = mask.shape
    _check_shapes("estimate_pose", [
        ("pts1", pts1, (P, K, 2)), ("pts2", pts2, (P, K, 2)),
        ("quality", quality, (P, K))])
    streams = _streams(cfg, P, generator, mask.device, uniforms=uniforms,
                       degen_uniforms=degen_uniforms,
                       plane_uniforms=plane_uniforms)
    uniforms = streams["uniforms"]
    degen_uniforms = streams.get("degen_uniforms")
    batch = (P,)
    dt = torch.float32
    maskf = mask.to(dt)
    maskb = mask.to(torch.bool)
    x1 = geo.undistort_oulu(geo.img_to_cam(pts1, K1), dist1)
    x2 = geo.undistort_oulu(geo.img_to_cam(pts2, K2), dist2)
    dev = x1.device
    f_mean = 0.25 * (K1[0, 0] + K1[1, 1] + K2[0, 0] + K2[1, 1])
    th = cfg.robust.threshold_px / f_mean
    th_sq = th * th
    n_val = torch.clamp(torch.sum(maskf, dim=-1), min=1.0)
    halign_code = torch.zeros(batch, dtype=torch.int32, device=dev)
    # the robust engine's counters (zero when Halign decides)
    zero = torch.zeros(batch, dtype=torch.int64, device=dev)
    counters = (zero, zero, zero, zero)

    if cfg.use_halign:
        # Halign (poselib-test --Halign; pose_homography.cpp:127): pose by
        # multi-plane homography extraction and decomposition. On its
        # error codes -1..-4 (pose_homography.cpp:200-266) the caller
        # falls back to robust E: the JAX package's lax.cond, under vmap a
        # per-pair select. Here the fallback runs when any pair failed
        # (one host read), for the failed pairs only
        hres = homography_pose.estimate_pose_halign(
            x1, x2, mask, quality, cfg.halign, cfg.robust,
            threshold_sq=th_sq, plane_uniforms=streams["plane_uniforms"])
        halign_code = hres.error_code
        ok = hres.error_code == 0
        E, inl, n_sel = hres.E, hres.inlier_mask, hres.n_inliers
        if HostSyncs.read(torch.any(~ok), "halign"):
            # the fallback's degeneracy result is discarded, so it is not
            # computed
            r, _ = robust.estimate_essential_robust(
                x1, x2, maskf, quality,
                dataclasses.replace(cfg.robust, check_degeneracy=False),
                threshold_sq=th_sq, uniforms=uniforms, tables=tables,
                active=~ok)
            E = torch.where(ok[:, None, None], E, r.model)
            inl = torch.where(ok[:, None], inl, r.inlier_mask)
            n_sel = torch.where(ok, n_sel, r.n_inliers)
        thr = th_sq.to(dt).expand(batch)
        degen_flag = hres.is_rotation_only & ok
    else:
        if cfg.auto_th:
            # AutoThEpi (poselib-test --autoTH; pose_estim.cpp:82-300): the
            # threshold adapts between robust rounds within [MIN_PIX_TH,
            # MAX_PIX_TH] pixels
            ath = robust.estimate_essential_autoth(
                x1, x2, maskf, quality, cfg.robust, threshold_sq=th_sq,
                min_threshold=MIN_PIX_TH / f_mean,
                max_threshold=MAX_PIX_TH / f_mean, uniforms=uniforms,
                degen_uniforms=degen_uniforms, tables=tables)
            res, degen = ath.result, ath.degen
        else:
            # SPRT-init parity (pose_estim.cpp:1814-1940): the
            # match-quality distribution bounds the hypothesis budget
            prior = torch.clamp(
                torch.sum(((quality > 0.4) & maskb).to(dt), dim=-1) / n_val,
                0.05, 0.95)
            res, degen = robust.estimate_essential_robust(
                x1, x2, maskf, quality, cfg.robust, threshold_sq=th_sq,
                prior_inlier_ratio=prior, uniforms=uniforms,
                degen_uniforms=degen_uniforms, tables=tables)
        E, inl, n_sel, thr = (res.model, res.inlier_mask, res.n_inliers,
                              res.threshold)
        counters = (res.n_models_generated, res.n_models_rejected,
                    res.n_points_verified, res.n_lo_refinements)
        degen_flag = (degen.is_degenerate if degen is not None
                      else torch.zeros(batch, dtype=torch.bool, device=dev))

    if cfg.refine.enabled:
        rres = refine.refine_essential_linear(
            E, x1, x2, maskf, thr, cfg.refine
        )
        # inlier-loss guard of the reference's refinement call sites
        keep = rres.n_inliers >= (n_sel // 2)
        E = torch.where(keep[..., None, None], rres.model, E)
        inl = torch.where(keep[..., None], rres.inlier_mask, inl)

    R, t, X, ok3d, _ = geo.recover_pose(E, x1, x2, inl.to(dt),
                                        vote_points=512)
    if cfg.refine.polish_rt:
        pol, inl_p = refine.polish_pose_iterative(
            R, t, x1, x2, inl.to(dt), maskf, thr,
            rounds=cfg.refine.polish_rounds,
            iterations=cfg.refine.polish_iterations,
            max_points=cfg.refine.polish_max_points,
        )
        keep = torch.sum(inl_p, dim=-1) >= (torch.sum(inl, dim=-1) * 3) // 4
        R = torch.where(keep[..., None, None], pol.R, R)
        t = torch.where(keep[..., None], pol.t, t)
        E = torch.where(keep[..., None, None], pol.E, E)
        inl = torch.where(keep[..., None], inl_p, inl)
        _, X, ok3d = geo.cheirality_counts(R, t, x1, x2, inl)

    if cfg.ba.enabled:
        # BART (poselib-test --BART=1 -> refineStereoBA, pose_estim.cpp:
        # 1083) in normalized camera coordinates (K = I), so the
        # pseudo-Huber delta is the pixel delta over the focal length
        eye = torch.eye(3, dtype=dt, device=dev)
        bres = ba.refine_stereo_ba(
            R, t, x1, x2, X, (inl & ok3d).to(dt), eye, eye, cfg.ba,
            huber_delta=cfg.ba.huber_delta / f_mean)
        R, t, X = bres.R, bres.t, bres.points
        E = geo.essential_from_rt(R, t)
        inl = (geo.sampson_error(E, x1, x2) < thr[:, None]) & maskb

    n_inl = torch.sum(inl, dim=-1)
    return PoseResult(
        R=R, t=t, E=E, inlier_mask=inl, n_inliers=n_inl,
        inlier_ratio=n_inl.to(dt) / n_val,
        points3d=X, valid3d=ok3d, is_degenerate=degen_flag,
        n_models_generated=counters[0], n_models_rejected=counters[1],
        n_points_verified=counters[2], n_lo_refinements=counters[3],
        halign_error_code=halign_code,
    )


class StereoPipeline:
    """Detect + describe + match + pose on stereo pairs.

    Owns the configs and a StageTimer with the reference's stage names;
    ``run`` executes the pipeline on one pair, ``run_batch`` on a batch of
    pairs with a leading pair axis.

    ``device``: where the pipeline runs, the CUDA card unless the caller
    asks for the CPU. ``run``, ``run_batch`` and ``correspondences`` move
    their inputs (numpy arrays or tensors) there; a ``generator`` must
    live there too. A CUDA device without a card raises: there is no
    fallback to the CPU.
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

    def _pose(self, corr, K1, K2, dist1, dist2, generator,
              **streams) -> PoseResult:
        with self.timer.stage("robEstimationAndRef") as h:
            pose = estimate_pose(
                corr.pts1, corr.pts2, corr.mask, corr.quality,
                self._to(K1), self._to(K2), self._to(dist1),
                self._to(dist2), self.pose_cfg, generator=generator,
                tables=self.solver_tables,
                **{k: self._to(v) for k, v in streams.items()},
            )
            h["outputs"] = pose
        return pose

    def run(self, img1, img2, K1, K2, dist1, dist2,
            generator: torch.Generator | None = None,
            uniforms: torch.Tensor | None = None,
            degen_uniforms: torch.Tensor | None = None,
            plane_uniforms: torch.Tensor | None = None) -> tuple:
        """One pair: correspondences, then ``estimate_pose`` with the
        sample streams given (see there), else drawn from `generator`."""
        corr = self.correspondences(img1, img2)
        pose = self._pose(corr, K1, K2, dist1, dist2, generator,
                          uniforms=uniforms, degen_uniforms=degen_uniforms,
                          plane_uniforms=plane_uniforms)
        return corr, pose

    def run_batch(self, imgs1, imgs2, K1, K2, dist1, dist2,
                  generator: torch.Generator | None = None,
                  uniforms: torch.Tensor | None = None,
                  degen_uniforms: torch.Tensor | None = None,
                  plane_uniforms: torch.Tensor | None = None) -> tuple:
        """Batched pairs: imgs1, imgs2 (P, H, W) with shared calibration ->
        (Correspondences, PoseResult), each with a leading pair axis P.

        Pair i equals ``run`` on pair i with pair i's streams, each of
        ``estimate_pose``'s shapes with a leading P (for the default
        branch uniforms (P, max_batches, B, k) and degen_uniforms (P, 1,
        min(B, 64), 4); AutoTh's rounds, Halign's plane_uniforms), else
        drawn from `generator` pair by pair as P ``run`` calls draw them.
        The single-scale FAST rows score all 2P images in one call of the
        fused kernel (the other detector rows detect image by image);
        descriptors, matching and the match filters run pair by pair; the
        pose stage runs once over the pair axis, for every PoseConfig
        branch. The stages are charged to the timer under ``run``'s four
        names.
        """
        imgs1, imgs2 = self._to(imgs1), self._to(imgs2)
        if imgs1.ndim != 3 or imgs1.shape != imgs2.shape or not len(imgs1):
            raise ValueError(
                f"run_batch: imgs1 {tuple(imgs1.shape)} and imgs2 "
                f"{tuple(imgs2.shape)} must both be (P, H, W), P >= 1")
        P = imgs1.shape[0]
        # refuse a wrong stream before any work
        _stream_shapes("run_batch", self.pose_cfg, P, uniforms,
                       degen_uniforms, plane_uniforms)
        binary = features.is_binary_descriptor(self.desc_cfg.kind)
        bold = features.is_bold_descriptor(self.desc_cfg.kind)
        bands = features.detector_bands(self.det_cfg)
        imgs = torch.cat([imgs1, imgs2])
        with self.timer.stage("keypoints") as h:
            kps = features.detect_keypoints_batch(imgs, self.det_cfg)
            h["outputs"] = kps
        with self.timer.stage("descriptors") as h:
            desc = [features.compute_descriptors(
                img, k, self.desc_cfg, bands, self.descriptor_tables)
                for img, k in zip(imgs, kps)]
            h["outputs"] = desc
        with self.timer.stage("matching") as h:
            corr = _stack([
                _match(i1, i2, d1, d2, k1, k2, binary, self.match_cfg,
                       tuple(imgs1.shape[1:]), bold)
                for i1, i2, (d1, k1), (d2, k2) in zip(imgs1, imgs2, desc[:P],
                                                      desc[P:])])
            h["outputs"] = corr
        pose = self._pose(corr, K1, K2, dist1, dist2, generator,
                          uniforms=uniforms, degen_uniforms=degen_uniforms,
                          plane_uniforms=plane_uniforms)
        return corr, pose
