"""Split the binary 2-NN kernel's time (csrc/knn2.cu) into its sweep and
the fixed cost of one launch, on one CUDA card.

    python3 chip_probes/knn2_fixed_cost.py

Device ms per call (torch.profiler, as chip_smoke.py times its kernels)
of the kernel at 2048 x 2048 on random words, unguided and guided; of
2048 rows against 64 columns, where the sweep is nearly no work and the
rest is the fixed cost of a launch (first loads, cluster barrier and
merge); and of a one-element elementwise kernel, the floor of any
launch. Prints one JSON line with the card's name and power limit.
Needs nvcc and a card; chip_smoke.py phase 3 holds the kernel's results
against its plain version.
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
        print("knn2_fixed_cost: no CUDA device", file=sys.stderr)
        return 2
    from matchinglib_poselib_torch.ops.kernels import knn2

    dev = torch.device("cuda:0")
    rng = np.random.default_rng(0)
    n = 2048
    words = torch.from_numpy(rng.integers(-2**31, 2**31, (2 * n, 8),
                                          dtype=np.int64).astype(np.int32))
    xy = torch.from_numpy(rng.uniform(0, 1392, (2 * n, 2))
                          .astype(np.float32)).to(dev)
    cases = chip_smoke.knn2_inputs(torch, rng, words[:n].to(dev),
                                   words[n:].to(dev), xy[:n], xy[n:], dev)
    d1, d2, valid2 = cases[0]
    narrow = (d1, d2[:64].contiguous(), valid2[:64].contiguous())
    one = torch.zeros(1, device=dev)
    timed = {
        "device_ms_2048x2048": cases[0],
        "device_ms_2048x2048_guided": cases[1],
        "device_ms_2048x64": narrow,
    }
    result = {"device": torch.cuda.get_device_name(0),
              "nvidia_smi": chip_smoke._nvidia_smi()}
    for name, args in timed.items():
        mode = 1 if name.endswith("guided") else 0
        result[name] = chip_smoke._device_ms(
            torch, functools.partial(knn2.knn2, *args, xy_mode=mode))
    result["device_ms_one_element_add"] = chip_smoke._device_ms(
        torch, lambda: one.add_(1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
