"""Build the three CUDA kernels and check them over their whole input
domain on the card, without the rest of chip_smoke.py.

    python3 chip_probes/kernel_domains.py [--seed N] [--skip-domains]

Prints ptxas's register / shared-memory lines, then holds the old domain
as phases 2, 3 and 3b of ``chip_smoke.py`` do (K1 at every pixel at the
scene's and the ragged shapes and every radius; K2a bit-exact at 2048 x
2048 on the scene's ORB descriptors and at ``KNN2_RAGGED`` x 2, 4, 8 and
16 words and the 512-bit key's extreme pairs; K2b at ``KNN2_L2_RAGGED``
x D = 128, 64, 67) with their device ms at phase 3's shapes, and runs
phase 12 (``chip_smoke.domains_phase``). One JSON line per part; exits
non-zero on a failed check. Needs one card.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--skip-domains", action="store_true")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("kernel_domains: no CUDA device", file=sys.stderr)
        return 2
    from matchinglib_poselib_torch import config as cfg
    from matchinglib_poselib_torch.ops import features
    from matchinglib_poselib_torch.ops.kernels import _build, fast_nms, knn2

    smi = cs._nvidia_smi()
    dev = torch.device("cuda:0")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    _build.build()
    for name, log in _build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                print(f"[ptxas {name}] {line.strip()}")
    det, desc, _, _ = cs.flagship_configs(cfg)
    img1, img2, _, _, _ = cs.render_scene(args.seed)
    i1 = torch.from_numpy(img1).to(dev)
    i2 = torch.from_numpy(img2).to(dev)
    thr = det.fast_threshold / 255.0
    one = i1[None].contiguous()
    two = torch.stack([i1, i2]).contiguous()
    rec = {"card": smi}
    (rec["k1_err"], rec["k1_ties"]), _ = cs.check_fast_nms_padded(
        torch, fast_nms, np.random.default_rng(args.seed + 3), (one, two),
        thr, dev)
    kp1, kp2 = (features.detect_keypoints(i, det) for i in (i1, i2))
    bands = features.detector_bands(det)
    d1, _ = features.compute_descriptors(i1, kp1, desc, bands)
    d2, _ = features.compute_descriptors(i2, kp2, desc, bands)
    rng = np.random.default_rng(args.seed)
    cases = cs.knn2_inputs(torch, rng, d1, d2, kp1.xy, kp2.xy, dev)
    rec["k2a_err"] = cs.check_knn2(torch, knn2, cases)
    for w in (2, 4, 8, 16):
        cs.check_knn2_ragged(torch, knn2, cs.knn2_ragged_cases(
            torch, np.random.default_rng(args.seed + 6 + w), dev, w))
    cs.check_knn2_extreme(torch, knn2, cs.knn2_extreme_cases(torch, dev))
    rec["k2b_err"] = cs.check_knn2_l2_ragged(torch, knn2,
                                             cs.knn2_l2_ragged_cases(
                                                 torch,
                                                 np.random.default_rng(
                                                     args.seed + 2), dev))
    sift = cfg.DetectorConfig(kind="SIFT", max_keypoints=2048)
    skp1, skp2 = (features.detect_keypoints(i, sift) for i in (i1, i2))
    f1, _ = features.compute_descriptors(i1, skp1, cfg.DescriptorConfig(
        kind="SIFT"))
    f2, _ = features.compute_descriptors(i2, skp2, cfg.DescriptorConfig(
        kind="SIFT"))
    ones = torch.ones(f2.shape[0], dtype=torch.bool, device=dev)
    rec["device_ms_phase3_shapes"] = {
        "fast_nms": cs._device_profile(torch, functools.partial(
            fast_nms.fast_nms_score, one, thr, det.nms_radius)),
        "knn2_unguided": cs._device_profile(torch, functools.partial(
            knn2.knn2, *cases[0])),
        "knn2_l2_unguided": cs._device_profile(torch, functools.partial(
            knn2.knn2_l2, f1.contiguous(), f2.contiguous(), ones))}
    print(json.dumps({"old_domain": rec}))
    if args.skip_domains:
        return 0
    dom, fails, dom_s = cs.domains_phase(torch, fast_nms, knn2, features,
                                         cfg, det, desc, i1, i2, dev,
                                         args.seed, n_sm)
    for part in ("k1", "maps", "wide", "l2", "sharded"):
        print(json.dumps({"domains": part, "card": smi,
                          "record": dom[part]}))
    print(json.dumps({"phase_12_s": dom_s, "failures": fails}))
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
