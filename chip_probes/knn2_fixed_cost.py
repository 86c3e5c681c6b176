"""Split the 2-NN kernels' time (csrc/knn2.cu, csrc/knn2_l2.cu) into
their sweep and the fixed cost of one launch, on one CUDA card.

    python3 chip_probes/knn2_fixed_cost.py

Device ms per call (torch.profiler, as chip_smoke.py times its kernels)
of each kernel at 2048 x 2048, unguided and guided; of 2048 rows against
64 columns, where the sweep is nearly no work and the rest is the fixed
cost of a launch (first loads, cluster barrier and merge); and of a
one-element elementwise kernel, the floor of any launch. The binary
kernel runs on random words; the float kernel on random unit rows at D =
128, beside the cuBLAS fp32 product ``a @ b.T`` at the same shape (TF32
off): the sweep's products alone, a reference, not the same function.
Prints one JSON line with the card's name and power limit. Needs nvcc
and a card; chip_smoke.py phases 3 and 3b hold the kernels' results
against their plain versions.
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

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    rng = np.random.default_rng(0)
    n, depth = 2048, 128
    words = torch.from_numpy(rng.integers(-2**31, 2**31, (2 * n, 8),
                                          dtype=np.int64).astype(np.int32))
    xy = torch.from_numpy(rng.uniform(0, 1392, (2 * n, 2))
                          .astype(np.float32)).to(dev)
    cases = chip_smoke.knn2_inputs(torch, rng, words[:n].to(dev),
                                   words[n:].to(dev), xy[:n], xy[n:], dev)
    rows = rng.normal(size=(2 * n, depth)).astype(np.float32)
    rows = torch.from_numpy(rows / np.linalg.norm(rows, axis=1,
                                                  keepdims=True)).to(dev)
    fcases, _, _ = chip_smoke.knn2_l2_inputs(torch, rng, rows[:n], rows[n:],
                                             xy[:n], xy[n:], dev)

    def narrow(args):
        return (args[0], args[1][:64].contiguous(), args[2][:64].contiguous())

    timed = {
        "knn2": (knn2.knn2, {
            "device_ms_2048x2048": (cases[0], 0),
            "device_ms_2048x2048_guided": (cases[1], 1),
            "device_ms_2048x64": (narrow(cases[0]), 0),
        }),
        "knn2_l2": (knn2.knn2_l2, {
            f"device_ms_2048x2048x{depth}": (fcases[0], 0),
            f"device_ms_2048x2048x{depth}_guided": (fcases[1], 1),
            f"device_ms_2048x64x{depth}": (narrow(fcases[0]), 0),
        }),
    }
    result = {"device": torch.cuda.get_device_name(0),
              "nvidia_smi": chip_smoke._nvidia_smi()}
    for kernel, (fn, shapes) in timed.items():
        result[kernel] = {
            name: chip_smoke._device_ms(
                torch, functools.partial(fn, *args, xy_mode=mode))
            for name, (args, mode) in shapes.items()}
    a, b = fcases[0][0], fcases[0][1]
    result["knn2_l2"][f"device_ms_cublas_fp32_a_bT_2048x2048x{depth}"] = (
        chip_smoke._device_ms(torch, lambda: a @ b.T))
    one = torch.zeros(1, device=dev)
    result["device_ms_one_element_add"] = chip_smoke._device_ms(
        torch, lambda: one.add_(1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
