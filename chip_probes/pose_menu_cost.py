"""Where the wall time of one pose branch of chip_smoke.py phase 4d goes,
on one CUDA card.

    python3 chip_probes/pose_menu_cost.py [--branch BA]

At the flagship config on chip_smoke's 1392x512 scene, with the branch's
seeded streams: seconds of one warm run, of one timed run, of one step
profiled with CPU and CUDA activity (as chip_smoke.py's `_profile_step`)
and of one profiled with CUDA activity only, each split into the
profiled step and `key_averages()`, with the device ops and device-busy
ms each reports; and of the pose stage rerun on the CPU from the card's
correspondences. Prints one JSON line with the card's name and power
limit. Needs a card (the kernels build with nvcc on first use).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402


def _profiled(torch, step, activities):
    """(step s, key_averages s, device ops, device-busy ms)."""
    from torch.profiler import profile

    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    device = [e for e in prof.key_averages()
              if e.device_type.name == "CUDA"]
    avg_s = time.perf_counter() - t0
    return (step_s, avg_s, sum(e.count for e in device),
            sum(e.self_device_time_total for e in device) / 1e3)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--branch", default="BA")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity

    if not torch.cuda.is_available():
        print("pose_menu_cost: no CUDA device", file=sys.stderr)
        return 2
    from matchinglib_poselib_torch import config as cfg
    from matchinglib_poselib_torch.models import pipeline
    from matchinglib_poselib_torch.ops import robust

    dev = torch.device("cuda:0")
    img1, img2, K, _, _ = chip_smoke.render_scene(0)
    i1 = torch.from_numpy(img1).to(dev)
    i2 = torch.from_numpy(img2).to(dev)
    Kt = torch.from_numpy(K).to(dev)
    dist = torch.zeros(5, device=dev)
    base = cfg.PoseConfig(
        robust=cfg.RobustConfig(batch_hypotheses=96, max_batches=12))
    menu = {name: change for name, change, _ in chip_smoke.pose_menu(cfg)}
    pose_cfg = dataclasses.replace(base, **menu[args.branch])
    streams = chip_smoke.pose_streams(torch, robust, pose_cfg, 0)
    pipe = pipeline.StereoPipeline(
        cfg.DetectorConfig(kind="FAST", max_keypoints=2048,
                           fast_threshold=12.0),
        cfg.DescriptorConfig(kind="ORB"),
        cfg.MatchingConfig(matcher_name="GMBSOF"), pose_cfg)

    def step():
        return pipe.run(i1, i2, Kt, Kt, dist, dist, **streams)

    out = {"branch": args.branch}
    for name in ("warm_s", "run_s"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        corr, pose = step()
        torch.cuda.synchronize()
        out[name] = time.perf_counter() - t0
    for name, acts in (("cpu_cuda", [ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]),
                       ("cuda_only", [ProfilerActivity.CUDA])):
        s, a, ops, busy = _profiled(torch, step, acts)
        out[name] = {"step_s": s, "key_averages_s": a, "device_ops": ops,
                     "device_busy_ms": busy}
    t0 = time.perf_counter()
    _, fails = chip_smoke.check_pose_card_vs_cpu(
        torch, pipeline, corr, pose, Kt, dist, pose_cfg, streams)
    out["cpu_check_s"] = time.perf_counter() - t0
    out["cpu_check_failures"] = fails
    out["card"] = chip_smoke._nvidia_smi()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
