"""Rehearse chip_smoke.py's phase 8 (the CLIs on files) on the CPU.

    python3 chip_probes/apps_rehearsal.py [--width 480 --height 240]

Runs ``chip_smoke.apps_phase`` with the CPU as its device at a reduced
image size: the PNGs and the KITTI calibration written, the loader's
check, ``poselib-test --compInitPose --showRect``, ``--stereoRef``,
``matchinglib-test`` and the three ``noMatch_poselib-test`` runs, each
comparison's second run on the CPU too. Prints the phase's record and its
failures as JSON lines. The kernels' launch checks fail here by design
(CPU tensors take the plain versions and count no launch); every time in
the record is a CPU time, not the card's.
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
    ap.add_argument("--width", type=int, default=480)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    rec, failures = chip_smoke.apps_phase(
        torch, torch.device("cpu"), args.seed, "CPU rehearsal",
        size=(args.height, args.width))
    print(json.dumps({"apps_phase": rec}))
    print(json.dumps({"failures": failures}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
