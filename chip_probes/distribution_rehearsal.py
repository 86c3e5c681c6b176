"""Rehearse chip_smoke.py's phase 11 (distribution) on the CPU.

    python3 chip_probes/distribution_rehearsal.py

Runs ``chip_smoke.distribution_phase`` with the CPU as every rank's
device and gloo as every world's backend, at a reduced size
(``SMALL``: databases of 16,384 and 4,096 rows, a BA window of 1,024
points), with phase 6's stream replaced by planted per-frame poses and
phase 7's batch by ``run_batch`` of 2 pairs of ``render_sequence`` at
480x240 on the CPU. The ranks are processes of their own, as on the card;
``PRELUDE`` replaces the card's calls in each. Prints the phase's records
and failures as JSON lines. The launch counts need the card (CPU tensors
take the plain versions and count no launch), so their checks fail here
and are listed apart; every time in the record is a CPU time, not the
card's.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from types import SimpleNamespace

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from matchinglib_poselib_torch import config as cfg  # noqa: E402

SMALL = {"DIST_DB_ROWS": 1 << 14, "DIST_FLOAT_DB_ROWS": 1 << 12,
         "DIST_BA_POINTS": 1024}
PRELUDE = "\n".join([
    "import torch, torch.distributed as dist",
    "torch.set_num_threads(2)",
    "torch.cuda.synchronize = lambda *a, **k: None",
    "torch.cuda.set_device = lambda *a, **k: None",
    "torch.cuda.set_sync_debug_mode = lambda *a, **k: None",
    "chip_smoke._rank_device = lambda torch, rank: torch.device('cpu')",
    "chip_smoke._device_events = lambda torch, fn: (fn(), ([], 0.0))[1]",
    *(f"chip_smoke.{k} = {v}" for k, v in SMALL.items()),
    "_init = dist.init_process_group",
    "dist.init_process_group = lambda backend, *a, **k: _init('gloo', *a, "
    "**k)",
])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    exec(PRELUDE.split("\n_init")[0], {"chip_smoke": chip_smoke})
    torch.cuda.device_count = lambda: 1
    dev = torch.device("cpu")
    from matchinglib_poselib_torch.models import pipeline
    from matchinglib_poselib_torch.ops import robust

    det, desc, match, pose_cfg = chip_smoke.flagship_configs(cfg)
    # phase 6's frames: a planted pose, each frame jittered
    rng = np.random.default_rng(args.seed)
    R_gt = chip_smoke._rot((0.2, 1.0, 0.1), 1.5)
    t_gt = chip_smoke._unit((-1.0, 0.02, 0.01))
    frames = [SimpleNamespace(
        R=chip_smoke._rot(rng.normal(size=3), 0.05) @ R_gt,
        t=chip_smoke._unit(t_gt + rng.normal(scale=2e-3, size=3)),
        inlier_ratio=0.9, R_most_likely=R_gt, t_most_likely=t_gt)
        for _ in range(10)]
    # phase 7's batch at 480x240
    pairs, K, _, _ = chip_smoke.render_sequence(args.seed, 2, 480, 240)
    imgs1 = torch.from_numpy(np.stack([a for a, _ in pairs]))
    imgs2 = torch.from_numpy(np.stack([b for _, b in pairs]))
    U, D = chip_smoke.batch_streams(torch, robust, pose_cfg, args.seed + 30,
                                    len(pairs))
    pipe = pipeline.StereoPipeline(det, desc, match, pose_cfg, device=dev)
    corr, pose = pipe.run_batch(imgs1, imgs2, K, K, np.zeros(5), np.zeros(5),
                                uniforms=U, degen_uniforms=D)
    sift = (cfg.DetectorConfig(kind="SIFT", max_keypoints=2048),
            cfg.DescriptorConfig(kind="SIFT"))
    recs, failures, wall_s = chip_smoke.distribution_phase(
        torch, cfg, sift, dev, args.seed, "CPU rehearsal",
        (frames, [2000] * len(frames)),
        (corr, pose, (imgs1, imgs2, torch.from_numpy(K), U, D)),
        prelude=PRELUDE)
    for line in chip_smoke.dist_lines(recs, "CPU rehearsal", 132)[0]:
        print(json.dumps(line, default=str))
    launch = [f for f in failures if "launches" in f]
    print(json.dumps({"wall_s": wall_s,
                      "failures": [f for f in failures if f not in launch],
                      "launch_checks_needing_the_card": launch}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
