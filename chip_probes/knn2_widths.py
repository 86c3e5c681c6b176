"""Build the binary 2-NN kernel (csrc/knn2.cu) and check it at every
descriptor width it takes, on one CUDA card.

    python3 chip_probes/knn2_widths.py

Bit-exact against ``knn2_plain`` at ``chip_smoke.KNN2_RAGGED`` x 2, 4, 8
and 16 words (``chip_smoke.knn2_ragged_cases``), on the extreme pairs of
the 512-bit key (``chip_smoke.knn2_extreme_cases``), and at 2048 x 2048
on random 8- and 16-word descriptors with xy_mode 0, 1 and 2
(``chip_smoke.knn2_inputs``); 17 words must raise. Prints the ptxas
register and shared-memory report of the build and one JSON line with
device ms per call (torch.profiler) at 2048 x 2048 for each width,
beside the card's name and power limit. A short first call for a changed
kernel; chip_smoke.py runs the same checks in phases 3 and 9.
"""

from __future__ import annotations

import functools
import json
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("knn2_widths: no CUDA device", file=sys.stderr)
        return 2
    from matchinglib_poselib_torch.ops.kernels import _build, knn2

    _build.build(("knn2",))
    for line in _build.BUILD_LOG.get("knn2", "").splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            print(f"[ptxas knn2] {line.strip()}")
    dev = torch.device("cuda:0")
    rng = np.random.default_rng(0)
    for width in (2, 4, 8, 16):
        chip_smoke.check_knn2_ragged(torch, knn2, chip_smoke.knn2_ragged_cases(
            torch, rng, dev, width))
    chip_smoke.check_knn2_extreme(torch, knn2,
                                  chip_smoke.knn2_extreme_cases(torch, dev))
    chip_smoke.check_knn2_extreme(torch, knn2, chip_smoke.knn2_extreme_cases(
        torch, dev, width=8))
    try:
        wide = torch.zeros((4, 17), dtype=torch.int32, device=dev)
        knn2.knn2(wide, wide, torch.ones(4, dtype=torch.bool, device=dev))
    except ValueError:
        pass
    else:
        raise AssertionError("knn2: 17 words did not raise")
    n = 2048
    xy = torch.from_numpy(rng.uniform(0, 1392, (2 * n, 2))
                          .astype(np.float32)).to(dev)
    out = {"card": chip_smoke._nvidia_smi(), "device_ms": {}}
    for width in (8, 16):
        words = torch.from_numpy(rng.integers(
            -2**31, 2**31, (2 * n, width), dtype=np.int64).astype(
                np.int32)).to(dev)
        cases = chip_smoke.knn2_inputs(torch, rng, words[:n], words[n:],
                                       xy[:n], xy[n:], dev)
        chip_smoke.check_knn2(torch, knn2, cases)
        out["device_ms"][f"{width}w"] = {
            m: chip_smoke._device_ms(torch, functools.partial(
                knn2.knn2, *cases[m], xy_mode=m)) for m in (0, 1, 2)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
