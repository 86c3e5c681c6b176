"""Rehearse chip_smoke.py's stream phase on the CPU, one frame at a time.

    python3 chip_probes/stream_rehearsal.py [--width 696 --height 256]
        [--pool 4096] [--keypoints 2048] [--frames 10]
        [--bad-right other|frame2] [--count-ops]

Runs the port's plain CPU path: the flagship front end (FAST t=12, ORB,
GMBSOF) on ``chip_smoke.render_sequence`` and ``StereoRefine`` at
``chip_smoke.stereo_ref_config`` with its pool capacity set to --pool
(the card runs 30,000; keep it small here) and seeded
``chip_smoke.SeededStreams``. ``--bad-right frame2`` gives frame 7 frame
2's right image instead of the other-texture one. ``--count-ops`` counts
the leaf ``aten`` ops each frame dispatches (``torch.profiler``, CPU
activity), a proxy for the launches the card would see, and the same for
one flagship ``StereoPipeline.run`` at 96 x 12 hypotheses for scale.
Prints one JSON line per frame: state, correspondences, pool size,
inlier ratio, rotation / translation error against the planted pose,
CPU seconds (not the card's), leaf ops.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from matchinglib_poselib_torch import config as cfg  # noqa: E402
from matchinglib_poselib_torch.models import pipeline  # noqa: E402
from matchinglib_poselib_torch.models.stereo_refine import (  # noqa: E402
    StereoRefine,
)


def leaf_ops(fn):
    """(result of fn(), number of leaf aten ops it dispatched)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    n = sum(1 for e in prof.events() if e.name.startswith("aten::")
            and not any(c.name.startswith("aten::") for c in e.cpu_children))
    return out, n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--width", type=int, default=696)
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--pool", type=int, default=4096)
    ap.add_argument("--keypoints", type=int, default=2048)
    ap.add_argument("--frames", type=int, default=chip_smoke.STREAM_FRAMES)
    ap.add_argument("--bad-right", choices=("other", "frame2"),
                    default="other")
    ap.add_argument("--count-ops", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)

    pairs, K, R, t = chip_smoke.render_sequence(
        args.seed, args.frames, args.width, args.height)
    if args.bad_right == "frame2":
        b = chip_smoke.STREAM_BAD_FRAME - 1
        pairs[b] = (pairs[b][0], pairs[1][1])
    det = cfg.DetectorConfig(kind="FAST", max_keypoints=args.keypoints,
                             fast_threshold=12.0)
    desc = cfg.DescriptorConfig(kind="ORB")
    match = cfg.MatchingConfig(matcher_name="GMBSOF")
    count = leaf_ops if args.count_ops else (lambda fn: (fn(), None))
    if args.count_ops:
        flag = pipeline.StereoPipeline(
            det, desc, match, cfg.PoseConfig(robust=cfg.RobustConfig(
                batch_hypotheses=96, max_batches=12)), device="cpu")
        _, n = count(lambda: flag.run(
            pairs[0][0], pairs[0][1], K, K, np.zeros(5), np.zeros(5),
            torch.Generator().manual_seed(args.seed)))
        print(json.dumps({"flagship_run_leaf_ops": n}))
    s = dataclasses.replace(chip_smoke.stereo_ref_config(cfg),
                            max_pool_correspondences=args.pool)
    pipe = pipeline.StereoPipeline(det, desc, match, s.pose, device="cpu")
    sr = StereoRefine(K, K, np.zeros(5), np.zeros(5), cfg=s, device="cpu",
                      streams=chip_smoke.SeededStreams(
                          torch, s.pose.robust, args.seed + 100))
    for f, (a, b) in enumerate(pairs, start=1):
        t0 = time.perf_counter()
        c = pipe.correspondences(a, b)
        t1 = time.perf_counter()
        r, n = count(lambda: sr.add_new_correspondences(
            c.pts1, c.pts2, c.mask, c.quality, desc_dist=c.distance))
        print(json.dumps({
            "frame": f, "state": r.state, "n_corr": int(c.n),
            "pool_size": r.pool_size, "inlier_ratio": r.inlier_ratio,
            "rot_err_deg": chip_smoke._rot_deg(R, r.R),
            "t_err_deg": chip_smoke._dir_deg(t, r.t),
            "cpu_corr_s": t1 - t0, "cpu_stereo_refine_s":
            time.perf_counter() - t1, "leaf_ops": n}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
