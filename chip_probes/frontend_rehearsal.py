"""Rehearse chip_smoke.py's phase 9 rows (the front-end menu) on the CPU.

    python3 chip_probes/frontend_rehearsal.py [--width 1392 --height 512]

Runs ``chip_smoke.frontend_row`` for every row of
``chip_smoke.frontend_rows`` with the CPU as its device, on the seeded
scene at the given size, one run per row with the row's seeded explicit
streams: the port's CPU path, whose pose errors show whether phase 9 can
hold every row to the accuracy bars, as it does. Prints one JSON line
per row (pose errors, correspondences, inliers, wall seconds) and its
failures. The launch checks are skipped (CPU tensors take the plain
versions and count no launch); every time is a CPU time, not the card's.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--width", type=int, default=chip_smoke.WIDTH)
    ap.add_argument("--height", type=int, default=chip_smoke.HEIGHT)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", default="", help="comma-separated row names")
    args = ap.parse_args(argv)
    from matchinglib_poselib_torch import config as cfg
    from matchinglib_poselib_torch.models import pipeline
    from matchinglib_poselib_torch.ops import kernels, robust

    img1, img2, K, R, t = chip_smoke.render_scene(args.seed, args.width,
                                                  args.height)
    imgs = ((img1, img2), (torch.from_numpy(img1), torch.from_numpy(img2)))
    match = cfg.MatchingConfig(matcher_name="GMBSOF")
    pose_cfg = cfg.PoseConfig(
        robust=cfg.RobustConfig(batch_hypotheses=96, max_batches=12))
    wanted = set(filter(None, args.rows.split(",")))
    for r_i, (name, det, desc) in enumerate(chip_smoke.frontend_rows(cfg)):
        if wanted and name not in wanted:
            continue
        rec, failures = chip_smoke.frontend_row(
            torch, kernels, pipeline, robust, name, det, desc, match,
            pose_cfg, imgs, torch.from_numpy(K), torch.zeros(5), (R, t),
            args.seed + 300 + r_i, 0, False, False)
        keep = ("row", "rot_err_deg", "t_err_deg", "n_corr", "n_inliers",
                "warm_s")
        print(json.dumps({k: rec[k] for k in keep} | {"failures": failures}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
