"""Pose-estimation CLI (reference: tests/poselib-test/main.cpp; port of
``apps/poselib_test.py``).

Full pipeline on a KITTI-calibrated stereo sequence, on the card:
correspondences, robust relative pose (USAC/RANSAC/ARRSAC/LMEDS, --autoTH,
--Halign), linear refinement (--refineRT), bundle adjustment (--BART), pose
comparison against the calibration extrinsics (--compInitPose),
rectification output (--showRect — saved to --output_path instead of an
on-screen display). ``--stereoRef`` switches to the StereoRefine
streaming framework (main.cpp:1389-1432).

Usage:
    python -m matchinglib_poselib_torch.apps.poselib_test \
        --img_path <dir> --c_file calib_cam_to_cam.txt --compInitPose
"""

from __future__ import annotations

import argparse
import json
import pathlib

import numpy as np
import torch

from matchinglib_poselib_torch.apps import common
from matchinglib_poselib_torch.models import pipeline
from matchinglib_poselib_torch.models.stereo_refine import StereoRefine
from matchinglib_poselib_torch.ops import geometry as geo, rectify
from matchinglib_poselib_torch.utils import io, visualize


def build_parser():
    p = argparse.ArgumentParser(
        prog="poselib-test",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    common.add_matching_options(p)
    common.add_pose_options(p)
    common.add_stereo_refine_options(p)
    return p


def hist_equal(img: torch.Tensor) -> torch.Tensor:
    """Histogram equalization via sorted-rank mapping (the reference uses
    cv::equalizeHist before matching): a stable sort, so that the many
    ties of an 8-bit image rank in pixel order as in the JAX package."""
    flat = img.reshape(-1)
    ranks = torch.argsort(torch.argsort(flat, stable=True), stable=True)
    return (ranks.to(torch.float32) / flat.numel()).reshape(img.shape)


def main(argv=None, device: torch.device | str = "cuda"):
    """Run the CLI on ``device``: the card unless the caller passes
    ``device="cpu"``."""
    args = build_parser().parse_args(argv)
    device = common.cli_device(device)
    det, desc, match = common.matching_configs(args)
    pose_cfg, kneip_iba = common.pose_config(args)
    timer = common.StageTimer(args.v, device)

    def dev(x):
        return common.to_device(x, device)

    img_dir = pathlib.Path(args.img_path)
    calib = io.load_kitti_calib(img_dir / args.c_file)
    K1 = dev(calib.K0)
    K2 = dev(calib.K1)
    nd = args.distcoeffNr
    d1 = dev(np.r_[calib.dist0[:nd], np.zeros(max(0, 5 - nd))])
    d2 = dev(np.r_[calib.dist1[:nd], np.zeros(max(0, 5 - nd))])

    pairs = io.load_stereo_sequence(
        args.img_path, args.l_img_pref, args.r_img_pref
    )[:: max(1, args.stepSize)]
    if not pairs:
        raise SystemExit(f"no stereo pairs in {args.img_path}")

    out_dir = pathlib.Path(args.output_path) if args.output_path else None
    if out_dir:
        out_dir.mkdir(parents=True, exist_ok=True)

    stereo_ref = None
    if args.stereoRef:
        sr_cfg = common.stereo_refine_config(args, pose_cfg, kneip_iba)
        stereo_ref = StereoRefine(
            calib.K0, calib.K1, calib.dist0[:5], calib.dist1[:5],
            cfg=sr_cfg, device=device,
            streams=common.stereo_refine_streams(sr_cfg),
        )

    generator = torch.Generator(device=device).manual_seed(0)
    results = []
    for i, (lp, rp) in enumerate(pairs):
        img1 = torch.from_numpy(io.load_image_gray(lp)).to(device)
        img2 = torch.from_numpy(io.load_image_gray(rp)).to(device)
        if args.histEqual:
            img1, img2 = hist_equal(img1), hist_equal(img2)

        timer.start("correspondences")
        corr = pipeline.get_correspondences(img1, img2, det, desc, match)
        timer.stop()

        if stereo_ref is not None:
            timer.start("stereoRefine")
            fr = stereo_ref.add_new_correspondences(
                corr.pts1, corr.pts2, corr.mask, corr.quality,
                desc_dist=corr.distance,
            )
            timer.stop()
            R, t = np.asarray(fr.R), np.asarray(fr.t)
            if args.useMostLikelyPose and fr.most_likely_pose_stable:
                R = np.asarray(fr.R_most_likely)
                t = np.asarray(fr.t_most_likely)
            rec = {
                "frame": i,
                "state": fr.state,
                "inlier_ratio": round(float(fr.inlier_ratio), 4),
                "pool_size": int(fr.pool_size),
                "stable": bool(fr.pose_is_stable),
            }
        else:
            timer.start("pose")
            streams = common.frame_streams(i, pose_cfg)
            pose = pipeline.estimate_pose(
                corr.pts1, corr.pts2, corr.mask, corr.quality,
                K1, K2, d1, d2, pose_cfg, generator=generator,
                **{k: dev(v) for k, v in streams.items()},
            )
            timer.stop()
            # the frame's printed values, in one host read
            (R, t, n, n_inl, ratio, degen, *usac) = common.to_host(
                pose.R, pose.t, corr.n, pose.n_inliers, pose.inlier_ratio,
                pose.is_degenerate, pose.n_models_generated,
                pose.n_models_rejected, pose.n_points_verified,
                pose.n_lo_refinements)
            rec = {
                "frame": i,
                "n_matches": int(n),
                "n_inliers": int(n_inl),
                "inlier_ratio": round(float(ratio), 4),
                "degenerate": bool(degen),
            }
            if args.v > 0:
                # UsacResults counter parity (USAC.h:18-60)
                rec["usac"] = dict(zip(
                    ("models_generated", "models_rejected",
                     "points_verified", "lo_refinements"),
                    (int(c) for c in usac)))

        if args.compInitPose and not args.noPoseDiff:
            rd, td, _ = geo.compare_poses(
                torch.tensor(calib.R, dtype=torch.float32),
                torch.tensor(calib.t / np.linalg.norm(calib.t),
                             dtype=torch.float32),
                torch.tensor(R, dtype=torch.float32),
                torch.tensor(t, dtype=torch.float32),
            )
            rec["R_diff_deg"] = round(float(rd), 4)
            rec["t_angDiff_deg"] = round(float(td), 4)
        print(json.dumps(rec))
        results.append(rec)

        if args.showRect and out_dir is not None:
            hw = tuple(img1.shape)
            rect = rectify.get_rectification_parameters(
                K1, K2, dev(R), dev(t), d1, d2, hw,
            )
            r1, r2 = common.to_host(
                rectify.rectified_image(img1, K1, d1, rect.R1, rect.K_new1,
                                        hw),
                rectify.rectified_image(img2, K2, d2, rect.R2, rect.K_new2,
                                        hw))
            for name, arr in (("rect_left", r1), ("rect_right", r2)):
                visualize.write_png(
                    out_dir / f"{name}_{i:04d}.png",
                    (np.clip(arr, 0, 1) * 255).astype(np.uint8),
                )
            # ShowRectifiedImages parity (pose_helper.cpp:2636): stacked
            # pair with epipolar scan lines for visual verification
            visualize.write_png(
                out_dir / f"rect_pair_{i:04d}.png",
                visualize.draw_rectified_pair(r1, r2),
            )

    summary = {
        "frames": len(results),
        "stage_ms": {k: round(v, 2) for k, v in timer.stages.items()},
    }
    if args.compInitPose and results and "R_diff_deg" in results[0]:
        summary["R_diff_deg_median"] = round(
            float(np.median([r["R_diff_deg"] for r in results])), 4
        )
        summary["t_angDiff_deg_median"] = round(
            float(np.median([r["t_angDiff_deg"] for r in results])), 4
        )
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
