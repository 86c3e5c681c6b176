"""Entry point of the flagship step: one stereo pair through
``get_correspondences`` and ``estimate_pose`` (the PyTorch counterpart of
``__graft_entry__.entry``).

    fn, args = entry()            # card tensors; entry(device="cpu")
    R, t, n_inliers, n_matches = fn(*args)
"""

from __future__ import annotations

import numpy as np
import torch

from matchinglib_poselib_torch.apps import common
from matchinglib_poselib_torch.config import (
    DescriptorConfig,
    DetectorConfig,
    MatchingConfig,
    PoseConfig,
    RobustConfig,
)
from matchinglib_poselib_torch.models import pipeline

# the flagship step's shapes (__graft_entry__.py:46-47)
HEIGHT, WIDTH, MAX_KEYPOINTS, HYPOTHESES = 384, 512, 1024, 256


def flagship_step(max_keypoints: int = MAX_KEYPOINTS,
                  hypotheses: int = HYPOTHESES):
    """The flagship step: FAST t=12 at `max_keypoints` slots, ORB, GMBSOF,
    then the default pose stage at `hypotheses` x 4 batches. Returns
    step(img1, img2, K1, K2, dist1, dist2, generator) -> (R, t,
    n_inliers, n_matches)."""
    det = DetectorConfig(kind="FAST", max_keypoints=max_keypoints,
                         fast_threshold=12.0)
    desc = DescriptorConfig(kind="ORB")
    match = MatchingConfig(matcher_name="GMBSOF")
    pose = PoseConfig(robust=RobustConfig(batch_hypotheses=hypotheses,
                                          max_batches=4))

    def step(img1, img2, K1, K2, dist1, dist2, generator):
        corr = pipeline.get_correspondences(img1, img2, det, desc, match)
        res = pipeline.estimate_pose(
            corr.pts1, corr.pts2, corr.mask, corr.quality, K1, K2, dist1,
            dist2, pose, generator=generator)
        return res.R, res.t, res.n_inliers, corr.n

    return step


def entry(device: torch.device | str = "cuda"):
    """(fn, example_args) of the flagship step on `device` (the card
    unless the caller passes ``device="cpu"``; no card: RuntimeError):
    two seeded random 384 x 512 images, a 500 px pinhole K, no
    distortion, and a ``torch.Generator`` seeded 0."""
    device = common.cli_device(device, "entry")
    rng = np.random.default_rng(0)
    img1 = common.to_device(rng.random((HEIGHT, WIDTH)), device)
    img2 = common.to_device(rng.random((HEIGHT, WIDTH)), device)
    K = common.to_device([[500.0, 0.0, WIDTH / 2], [0.0, 500.0, HEIGHT / 2],
                          [0.0, 0.0, 1.0]], device)
    dist = torch.zeros(5, dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    return flagship_step(), (img1, img2, K, K, dist, dist, gen)
