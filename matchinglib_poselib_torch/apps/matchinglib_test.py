"""Feature-matching CLI (reference: tests/matchinglib-test/main.cpp; port
of ``apps/matchinglib_test.py``).

Loads a mono or stereo image sequence by filename prefix, runs the full
correspondence pipeline on every pair on the card, prints match counts and
stage timings, optionally stores keypoints+matches to ``--output_path``.

Usage:
    python -m matchinglib_poselib_torch.apps.matchinglib_test \
        --img_path <dir> --l_img_pref left_ --r_img_pref right_ \
        --f_detect FAST --d_extr ORB --matcher GMBSOF
"""

from __future__ import annotations

import argparse
import json
import pathlib

import numpy as np
import torch

from matchinglib_poselib_torch.apps import common
from matchinglib_poselib_torch.models import pipeline
from matchinglib_poselib_torch.utils import io, visualize


def build_parser():
    p = argparse.ArgumentParser(
        prog="matchinglib-test",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    common.add_matching_options(p)
    return p


def main(argv=None, device: torch.device | str = "cuda"):
    """Run the CLI on ``device``: the card unless the caller passes
    ``device="cpu"``."""
    args = build_parser().parse_args(argv)
    device = common.cli_device(device)
    det, desc, match = common.matching_configs(args)
    timer = common.StageTimer(args.v, device)

    pairs = io.load_stereo_sequence(
        args.img_path, args.l_img_pref, args.r_img_pref
    )
    if not pairs:
        seq = io.load_image_sequence(args.img_path, args.l_img_pref)
        pairs = list(zip(seq[:-1], seq[1:]))
    if not pairs:
        raise SystemExit(f"no images found in {args.img_path}")

    out_dir = pathlib.Path(args.output_path) if args.output_path else None
    if out_dir:
        out_dir.mkdir(parents=True, exist_ok=True)

    total = 0
    for i, (lp, rp) in enumerate(pairs):
        timer.start("load")
        host1 = io.load_image_gray(lp)
        host2 = io.load_image_gray(rp)
        img1 = torch.from_numpy(host1).to(device)
        img2 = torch.from_numpy(host2).to(device)
        timer.stop()
        timer.start("correspondences")
        corr = pipeline.get_correspondences(img1, img2, det, desc, match)
        # every value the frame prints or stores, in one host read
        m, pts1, pts2, dist = common.to_host(corr.mask, corr.pts1, corr.pts2,
                                             corr.distance)
        n = int(m.sum())
        timer.stop()
        total += n
        print(f"pair {i} ({lp.name} <-> {rp.name}): {n} matches")
        if args.v >= 2:
            flow = pts2[m] - pts1[m]
            if m.any():
                print(
                    f"  flow median ({np.median(flow[:, 0]):.2f}, "
                    f"{np.median(flow[:, 1]):.2f}) px"
                )
        if out_dir:
            np.savez_compressed(
                out_dir / f"matches_{i:04d}.npz",
                pts1=pts1[m], pts2=pts2[m], distance=dist[m],
            )
            if args.showNr != -3:
                # headless storeMatches/showMatches parity
                # (matchinglib-test/main.cpp:84,89): side-by-side match
                # image; --showNr caps drawn matches (-3 disables)
                img = visualize.draw_matches(
                    host1, pts1, host2, pts2, mask=m, max_draw=args.showNr,
                )
                visualize.write_png(out_dir / f"matches_{i:04d}.png", img)
    print(
        json.dumps(
            {
                "pairs": len(pairs),
                "total_matches": total,
                "stage_ms": {k: round(v, 2) for k, v in timer.stages.items()},
            }
        )
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
