"""Count the aten ops that the robust and matching options dispatch, on
the CPU: a proxy for the device ops of chip_smoke.py's phases 4d (LMEDS,
Stewenius) and 4e (subpix + VFC, the SOF filter).

    python3 chip_probes/option_op_count.py [--width 696 --height 256]
        [--keypoints 2048]

On ``chip_smoke.render_scene`` at the flagship config (FAST t=12, ORB,
GMBSOF, 96 x 12 hypotheses) with seeded ``chip_smoke.pose_streams``:
the ops of one ``estimate_pose`` for the flagship and each robust option,
and of one ``get_correspondences`` for the flagship and each matching
option. Counts every aten op but views (``TorchDispatchMode``). Prints
one JSON line per row: ops, robust batches, CPU seconds (not the
card's), rotation / translation error against the planted pose.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from matchinglib_poselib_torch import config as cfg  # noqa: E402
from matchinglib_poselib_torch.models import pipeline  # noqa: E402
from matchinglib_poselib_torch.ops import robust  # noqa: E402

_VIEWS = ("view", "expand", "select", "slice", "unsqueeze", "squeeze",
          "permute", "transpose", "alias", "_reshape", "t.default",
          "as_strided", "detach", "diagonal", "unbind", "split")


class OpCount(TorchDispatchMode):
    """Counts the aten ops dispatched inside it, views left out."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not any(v in str(func) for v in _VIEWS):
            self.n += 1
        return func(*args, **(kwargs or {}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--width", type=int, default=696)
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--keypoints", type=int, default=2048)
    args = ap.parse_args(argv)

    img1, img2, K, R, t = chip_smoke.render_scene(0, args.width, args.height)
    i1, i2, Kt = (torch.from_numpy(x) for x in (img1, img2, K))
    det = cfg.DetectorConfig(max_keypoints=args.keypoints,
                             fast_threshold=12.0)
    match = cfg.MatchingConfig()
    base = cfg.PoseConfig(robust=cfg.RobustConfig(batch_hypotheses=96,
                                                  max_batches=12))
    corr = pipeline.get_correspondences(i1, i2, det)
    rows = [("flagship", {})] + [
        (name, change) for name, change, _ in
        chip_smoke.pose_menu(cfg, base.robust) if "robust" in change]
    for name, change in rows:
        pose_cfg = dataclasses.replace(base, **change)
        streams = chip_smoke.pose_streams(torch, robust, pose_cfg, 14)
        t0 = time.perf_counter()
        with OpCount() as c:
            pose = pipeline.estimate_pose(
                corr.pts1, corr.pts2, corr.mask, corr.quality, Kt, Kt,
                torch.zeros(5), torch.zeros(5), pose_cfg, **streams)
        print(json.dumps({
            "pose": name, "ops": c.n,
            "batches": int(pose.n_models_generated) // (96 * 10),
            "cpu_s": time.perf_counter() - t0,
            "rot_err_deg": chip_smoke._rot_deg(R, pose.R.numpy()),
            "t_err_deg": chip_smoke._dir_deg(t, pose.t.numpy())}))
    for name, m_cfg in [("flagship", match)] + [
            (n, m) for n, m, _ in chip_smoke.match_menu(cfg, match)]:
        t0 = time.perf_counter()
        with OpCount() as c:
            out = pipeline.get_correspondences(i1, i2, det, match_cfg=m_cfg)
        print(json.dumps({"matching": name, "ops": c.n,
                          "correspondences": int(out.n),
                          "cpu_s": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
