"""Match one stereo pair and estimate its relative pose (the port's
counterpart of ``examples/match_and_pose.py``, after the reference's
matchinglibcmd example).

    python -m matchinglib_poselib_torch.examples.match_and_pose <image_dir>

<image_dir> holds left_* / right_* images and a KITTI
``calib_cam_to_cam.txt``; the first pair is matched on the card.
"""

from __future__ import annotations

import argparse
import pathlib

import torch

from matchinglib_poselib_torch.apps import common
from matchinglib_poselib_torch.config import (
    DescriptorConfig,
    DetectorConfig,
    MatchingConfig,
    PoseConfig,
)
from matchinglib_poselib_torch.models import pipeline
from matchinglib_poselib_torch.utils import io


def main(argv=None, device: torch.device | str = "cuda"):
    """Print the match count, R, t and the inlier count of the first
    pair; on the card unless the caller passes ``device="cpu"``."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("image_dir", help="directory with left_* / right_* "
                   "images and calib_cam_to_cam.txt")
    d = pathlib.Path(p.parse_args(argv).image_dir)
    device = common.cli_device(device)
    img1 = torch.from_numpy(io.load_image_gray(
        next(iter(sorted(d.glob("left_*")))))).to(device)
    img2 = torch.from_numpy(io.load_image_gray(
        next(iter(sorted(d.glob("right_*")))))).to(device)
    calib = io.load_kitti_calib(d / "calib_cam_to_cam.txt")

    corr = pipeline.get_correspondences(
        img1, img2,
        DetectorConfig(kind="FAST", max_keypoints=2048),
        DescriptorConfig(kind="ORB"),
        MatchingConfig(matcher_name="GMBSOF"),
    )
    print(f"{int(corr.n)} matches")

    res = pipeline.estimate_pose(
        corr.pts1, corr.pts2, corr.mask, corr.quality,
        *(common.to_device(a, device) for a in (
            calib.K0, calib.K1, calib.dist0, calib.dist1)),
        PoseConfig(), generator=torch.Generator(device=device).manual_seed(0),
    )
    R, t, n_inl = common.to_host(res.R, res.t, res.n_inliers)
    print("R =", R, "\nt =", t, f"\n{int(n_inl)} inliers", sep="")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
