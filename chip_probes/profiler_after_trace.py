"""Does torch.profiler still see the card's kernels in a process after
``utils.profiling.trace`` has written a Chrome trace?

    python3 chip_probes/profiler_after_trace.py

Profiles K1 at (1, 512, 1392) with ``chip_smoke._device_profile`` (CPU
and CUDA activities) and ``chip_smoke._device_events`` (CUDA only), runs
one K1 call under ``trace`` into a temporary directory, and profiles
again both ways. Prints one JSON line: (device ms, kernels per call)
and the device events' count before and after. Needs one card.
"""

from __future__ import annotations

import functools
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch

    from matchinglib_poselib_torch.ops.kernels import fast_nms
    from matchinglib_poselib_torch.utils.profiling import trace

    img, _, _, _, _ = cs.render_scene(0)
    one = torch.from_numpy(img).cuda()[None].contiguous()
    k1 = functools.partial(fast_nms.fast_nms_score, one, 12.0 / 255.0, 3)
    out = {"card": cs._nvidia_smi()}

    def measure(tag):
        out[tag] = {"device_profile": cs._device_profile(torch, k1),
                    "cuda_only_events": sum(
                        e.count for e in cs._device_events(torch, k1)[0])}

    measure("before")
    with tempfile.TemporaryDirectory() as d:
        with trace(d):
            k1()
            torch.cuda.synchronize()
        out["trace_files"] = len(os.listdir(d))
    measure("after")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
