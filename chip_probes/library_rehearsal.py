"""Rehearse chip_smoke.py's phase 10 (the library layer) on the CPU.

    python3 chip_probes/library_rehearsal.py

Runs ``chip_smoke.library_phase`` with the CPU as its device at the
phase's full size: the four estimators on the scene's correspondences and
on the planted pure rotation, LK flow with LKOF and ALKOF on the
sequence's first two frames, the node over frames 1-3 plain and with
stereoRef, ``entry()`` under ``trace`` and the example. Prints the
phase's record and its failures as JSON lines. The kernel checks and the
launch counts need the card and are skipped here (CPU tensors take the
plain versions and count no launch); every time in the record is a CPU
time, not the card's, and each "card vs CPU" comparison compares the CPU
with itself.
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
from matchinglib_poselib_torch import config as cfg  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    det = cfg.DetectorConfig(kind="FAST", max_keypoints=2048,
                             fast_threshold=12.0)
    robust = cfg.RobustConfig(batch_hypotheses=96, max_batches=12)
    rec, failures, wall_s = chip_smoke.library_phase(
        torch, torch.device("cpu"), args.seed, det,
        cfg.DescriptorConfig(kind="ORB"),
        cfg.MatchingConfig(matcher_name="GMBSOF"), robust)
    print(json.dumps({"library_phase": rec, "wall_s": wall_s},
                     default=str))
    print(json.dumps({"failures": failures}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
