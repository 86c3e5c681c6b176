"""Device ms of the three kernels at phase 3's shapes, for checkouts of
the repository in turns.

    python3 chip_probes/phase3_times.py DIR [DIR ...]

Each DIR is a checkout (for two commits: ``git archive`` of each unpacked
under ``_proof/``, given in the order parent, change, change, parent).
Each runs in a fresh process that imports ``chip_smoke`` and the port
from DIR, builds DIR's kernels and prints one JSON line: the card, K1 at
(1, 512, 1392), t = 12/255, r = 3; K2a unguided and guided at 2048 x 2048
on the scene's ORB descriptors (``chip_smoke.knn2_inputs``); K2b
unguided at 2048 x 2048 x 128 on the scene's SIFT descriptors; each as
``_device_profile`` gives it (device ms, kernels per call). Needs one
card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys


def child(root: str) -> int:
    sys.path.insert(0, root)
    import functools

    import numpy as np
    import torch

    import chip_smoke as cs
    from matchinglib_poselib_torch import config as cfg
    from matchinglib_poselib_torch.ops import features
    from matchinglib_poselib_torch.ops.kernels import _build, fast_nms, knn2

    dev = torch.device("cuda:0")
    _build.build()
    det, desc, _, _ = cs.flagship_configs(cfg)
    img1, img2, _, _, _ = cs.render_scene(0)
    i1 = torch.from_numpy(img1).to(dev)
    i2 = torch.from_numpy(img2).to(dev)
    kp1, kp2 = (features.detect_keypoints(i, det) for i in (i1, i2))
    bands = features.detector_bands(det)
    d1, _ = features.compute_descriptors(i1, kp1, desc, bands)
    d2, _ = features.compute_descriptors(i2, kp2, desc, bands)
    cases = cs.knn2_inputs(torch, np.random.default_rng(0), d1, d2, kp1.xy,
                           kp2.xy, dev)
    sift = cfg.DetectorConfig(kind="SIFT", max_keypoints=2048)
    f1, f2 = (features.compute_descriptors(
        i, features.detect_keypoints(i, sift),
        cfg.DescriptorConfig(kind="SIFT"))[0].contiguous() for i in (i1, i2))
    ones = torch.ones(f2.shape[0], dtype=torch.bool, device=dev)
    calls = {
        "fast_nms": functools.partial(fast_nms.fast_nms_score,
                                      i1[None].contiguous(),
                                      det.fast_threshold / 255.0,
                                      det.nms_radius),
        "knn2_unguided": functools.partial(knn2.knn2, *cases[0]),
        "knn2_guided": functools.partial(knn2.knn2, *cases[1], xy_mode=1),
        "knn2_l2_unguided": functools.partial(knn2.knn2_l2, f1, f2, ones)}
    print(json.dumps({"dir": root, "card": cs._nvidia_smi(), **{
        k: cs._device_profile(torch, fn) for k, fn in calls.items()}}),
        flush=True)
    return 0


def main(argv) -> int:
    if argv[:1] == ["--child"]:
        return child(os.path.abspath(argv[1]))
    rc = 0
    for root in argv:
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--child", root]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
