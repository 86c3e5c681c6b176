"""Drive the PyTorch port's main paths on one CUDA card and check them.

    python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero):
  1. build the CUDA kernels from ``matchinglib_poselib_torch/csrc`` (one
     nvcc per source, in parallel);
  2. fused FAST+NMS kernel vs its plain version on the scene's images at
     (1, 512, 1392) and (2, 512, 1392): equal away from the border, up to
     f32 ties inside an NMS window;
  3. fused binary 2-NN kernel vs its plain version at 2048 x 2048 on the
     scene's ORB descriptors, xy_mode 0, 1 and 2, with ~10% invalid
     columns and planted ties: bit-exact;
  3b. fused float 2-NN kernel vs its plain version (cuBLAS fp32, TF32
     off) on the scene's SIFT (2048 x 2048 x 128) and M-SURF (x 64)
     descriptors, xy_mode 0, 1 and 2, ~10% invalid columns, planted
     duplicate candidates and a block of fully gated rows: distances
     within 1e-5 (1 + |d|), idx equal where the gap exceeds 1e-5, the
     duplicates' lowest column and the gated rows' (1e9, 1e9, -1) exact;
  4. ``StereoPipeline.run`` at the flagship config (FAST t=12, 2048
     keypoints, ORB, GMBSOF, 96 x 12 five-point hypotheses) on a seeded
     synthetic 1392x512 stereo scene with a planted pose: one warm run,
     then timed runs; launch counters must show both kernels on the path;
     the pose must meet the accuracy bars;
  5. the port's CPU path on the same pair: keypoint and match slots agree
     with the card's;
  4b. the same at SIFT/SIFT + GMBSOF + GMS (2048 keypoints, 96 x 12):
     warm run, timed runs, the float 2-NN kernel launched twice and no
     other, accuracy bars, the CPU path's slots agree with the card's;
  4c. SURF/SURF + GMBSOF, one run: the float 2-NN kernel twice, accuracy
     bars.

Prints a JSON ``kernels`` line, one JSON ``step`` line per path, the
card's name and power limit, and as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys
import time

import numpy as np

WIDTH, HEIGHT = 1392, 512
K_FULL = np.array([[980.0, 0.0, 690.0], [0.0, 975.0, 247.0], [0.0, 0.0, 1.0]])
TIMED_RUNS = 20
# accuracy bars against the planted pose (tests/test_pipeline.py:88-89)
MAX_ROT_DEG, MAX_TANG_DEG = 1.0, 5.0
MIN_CORR, MIN_INLIERS = 300, 200
# published H100 SXM peaks (NVIDIA H100 datasheet; CUDA C++
# Programming Guide throughput table, compute capability 9.0)
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12
SM_CLOCK_HZ = 1.98e9  # maximum boost clock
POPC_PER_CLK_SM = 16


# ---------------------------------------------------------------------------
# seeded synthetic stereo scene
# ---------------------------------------------------------------------------


def _rot(axis, deg):
    axis = np.asarray(axis, float) / np.linalg.norm(axis)
    a = np.deg2rad(deg)
    Kx = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                   [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(a) * Kx + (1 - np.cos(a)) * Kx @ Kx


def _unit(v):
    v = np.asarray(v, float)
    return v / np.linalg.norm(v)


def _planes(rng):
    """Textured planes (origin, axis a, axis b, u range, v range, cell m):
    ground, back wall and three slanted box faces at 6-40 m depth."""
    specs = [
        ((0.0, 1.65, 0.0), (1, 0, 0), (0, 0, 1), (-40, 40), (1.0, 80), 0.10),
        ((0.0, 0.0, 40.0), (1, 0, 0), (0, 1, 0), (-80, 80), (-40, 1.65),
         0.30),
        ((-2.6, 0.3, 9.0), _unit((0.87, 0, 0.5)), (0, 1, 0), (-1.6, 1.6),
         (-1.6, 1.35), 0.07),
        ((2.8, 0.5, 14.0), _unit((0.9, 0, -0.43)), (0, 1, 0), (-1.8, 1.8),
         (-1.8, 1.15), 0.09),
        ((0.7, -0.3, 6.5), _unit((1, 0, 0.25)), _unit((0, 0.95, 0.3)),
         (-0.9, 0.9), (-0.7, 0.7), 0.05),
    ]
    planes = []
    for p0, a, b, ur, vr, cell in specs:
        a, b = _unit(a), _unit(b)
        tex = rng.uniform(0.08, 0.92, size=(256, 256))
        planes.append((np.asarray(p0, float), a, b, np.cross(a, b), ur, vr,
                       cell, tex))
    return planes


def _render(planes, K, R, t, width, height, rng, noise, ss=2):
    """Ray-cast the planes into camera [R|t] (X_cam = R X + t), with
    ss x ss supersampling per pixel and Gaussian pixel noise."""
    off = (np.arange(ss) + 0.5) / ss - 0.5
    u = (np.arange(width)[None, :, None, None] + off[None, None, None, :])
    v = (np.arange(height)[:, None, None, None] + off[None, None, :, None])
    u, v = np.broadcast_arrays(u, v)
    pix = np.stack([u, v, np.ones_like(u)], axis=-1).reshape(-1, 3)
    d = pix @ np.linalg.inv(K).T @ R  # ray directions in the world frame
    origin = -R.T @ t
    best = np.full(len(d), np.inf)
    val = np.full(len(d), 0.5)
    for p0, a, b, n, ur, vr, cell, tex in planes:
        den = d @ n
        # rays parallel to the plane give inf/nan; they never hit
        with np.errstate(divide="ignore", invalid="ignore"):
            lam = ((p0 - origin) @ n) / den
            X = origin + lam[:, None] * d
            pu = (X - p0) @ a
            pv = (X - p0) @ b
        hit = ((lam > 0) & (lam < best) & (pu >= ur[0]) & (pu <= ur[1])
               & (pv >= vr[0]) & (pv <= vr[1]))
        iu = np.floor(pu[hit] / cell).astype(np.int64) % tex.shape[1]
        iv = np.floor(pv[hit] / cell).astype(np.int64) % tex.shape[0]
        best[hit] = lam[hit]
        val[hit] = tex[iv, iu]
    img = val.reshape(height, width, ss * ss).mean(-1)
    img = img + rng.normal(scale=noise, size=img.shape)
    return np.clip(img, 0.0, 1.0).astype(np.float32)


def render_scene(seed: int = 0, width: int = WIDTH, height: int = HEIGHT,
                 noise: float = 0.005):
    """Seeded stereo pair with a planted pose.

    Returns (img1, img2, K, R, t): float32 images (H, W) in [0, 1], the
    shared intrinsics (K_FULL scaled to the size), and the planted
    relative pose X2 = R X1 + t with a KITTI-like 0.54 m baseline along
    -x, a small forward part and a ~1.5 deg rotation.
    """
    rng = np.random.default_rng(seed)
    K = K_FULL.copy()
    K[0] *= width / WIDTH
    K[1] *= height / HEIGHT
    R = _rot((0.15, 1.0, 0.1), 1.5)
    t = np.array([-0.54, 0.01, 0.04])
    planes = _planes(rng)
    img1 = _render(planes, K, np.eye(3), np.zeros(3), width, height, rng,
                   noise)
    img2 = _render(planes, K, R, t, width, height, rng, noise)
    return img1, img2, K.astype(np.float32), R, t


# ---------------------------------------------------------------------------
# measurement helpers
# ---------------------------------------------------------------------------


def _cuda_ms(torch, fn, iters=20, warm=3):
    """Mean milliseconds per call on the stream, by CUDA events around
    `iters` back-to-back calls after `warm` warm-up calls. Includes any
    time the card waits for the host to launch the next call."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(torch, fn, iters=10):
    """Summed device time of every kernel `fn` launches, per call, from
    torch.profiler: unlike CUDA events around back-to-back calls it leaves
    out the gaps where the card waits for the host to launch."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type.name == "CUDA") / 1e3 / iters


def _profile_step(torch, step):
    """One step under torch.profiler: (device-busy ms = summed device
    time of its kernels and copies, number of device ops, wall ms of the
    profiled step, which the profiler itself slows)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device = [e for e in prof.key_averages()
              if e.device_type.name == "CUDA"]
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    return busy_ms, sum(e.count for e in device), wall_ms


def _nvidia_smi() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


def _rot_deg(Ra, Rb):
    """Angle of Ra^T Rb from the chordal distance |Ra - Rb|_F = 2 sqrt(2)
    sin(angle / 2): unlike the trace form, it does not saturate at 0 when
    a float32 rotation is orthonormal only to ~1e-6."""
    d = np.linalg.norm(np.asarray(Ra, np.float64) - np.asarray(Rb, np.float64))
    half = np.arcsin(min(1.0, d / (2.0 * np.sqrt(2.0))))
    return float(np.degrees(2.0 * half))


def _dir_deg(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    c = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def check_fast_nms(torch, fast_nms, imgs, threshold, radius, border=16):
    """Kernel vs plain on the card: equal at every pixel `border` or more
    from the edge, except where an NMS decision differs because another
    pixel of the window holds the same score (an f32 tie). Returns (max
    |kernel - plain| over the interior, number of tie mismatches)."""
    out = fast_nms.fast_nms_score(imgs, threshold, radius)
    ref = fast_nms.fast_nms_score_plain(imgs, threshold, radius)
    torch.cuda.synchronize()
    oi = out[:, border:-border, border:-border]
    ri = ref[:, border:-border, border:-border]
    max_err = float((oi - ri).abs().max())
    bad = torch.nonzero(oi != ri).cpu().numpy()
    o, r = out.cpu().numpy(), ref.cpu().numpy()
    for b, y, x in bad:
        y, x = y + border, x + border
        v = max(o[b, y, x], r[b, y, x])
        tie = False
        if min(o[b, y, x], r[b, y, x]) == 0.0:  # one side suppressed it
            for dy in range(-radius, radius + 1):
                for dx in range(-radius, radius + 1):
                    if (dy or dx) and abs(max(o[b, y + dy, x + dx],
                                              r[b, y + dy, x + dx]) - v) \
                            <= 1e-6 * max(v, 1.0):
                        tie = True
        if not tie:
            raise AssertionError(
                f"fast_nms: non-tie mismatch at {(b, y, x)}: "
                f"kernel {o[b, y, x]} plain {r[b, y, x]}")
    if int((oi > 0).sum()) < 1000:
        raise AssertionError("fast_nms: implausibly few corners")
    return max_err, len(bad)


def knn2_inputs(torch, rng, d1, d2, xy1, xy2, dev):
    """The main path's 2048 x 2048 descriptors with ~10% invalid columns,
    planted ties (duplicate candidates) and SOF-like gates."""
    n1, n2 = d1.shape[0], d2.shape[0]
    d2 = d2.clone()
    dup = rng.choice(n2, 64, replace=False)
    d2[dup[:32]] = d2[dup[32:]]          # equal candidates: index ties
    d2[dup[:8]] = d1[dup[8:16]]          # exact copies of queries
    valid2 = torch.from_numpy(rng.random(n2) > 0.1).to(dev)
    pred = (xy1 + torch.from_numpy(
        rng.normal(scale=8.0, size=(n1, 2)).astype(np.float32)).to(dev))
    rad_q = torch.from_numpy(
        (rng.uniform(20, 80, n1) ** 2).astype(np.float32)).to(dev)
    rad_c = torch.from_numpy(
        (rng.uniform(20, 80, n2) ** 2).astype(np.float32)).to(dev)
    return {
        0: (d1, d2, valid2),
        1: (d1, d2, valid2, pred, rad_q, xy2.contiguous()),
        2: (d1, d2, valid2, pred, rad_c, xy2.contiguous()),
    }


def check_knn2(torch, knn2, cases):
    """Kernel vs plain on the card, bit-exact on all three outputs.
    Returns the max |kernel - plain| over the outputs."""
    max_err = 0.0
    for mode, args in cases.items():
        got = knn2.knn2(*args, xy_mode=mode)
        want = knn2.knn2_plain(*args, xy_mode=mode)
        for name, g, w in zip(("d_best", "d_second", "idx"), got, want):
            if not torch.equal(g, w):
                n_bad = int((g != w).sum())
                raise AssertionError(
                    f"knn2 xy_mode={mode}: {name} differs in {n_bad} rows")
            max_err = max(max_err, float((g.double() - w.double()).abs()
                                         .max()))
        if int((got[2] >= 0).sum()) < 100:
            raise AssertionError(f"knn2 xy_mode={mode}: implausibly few "
                                 "neighbours")
    return max_err


def knn2_l2_inputs(torch, rng, d1, d2, xy1, xy2, dev, n_gated=64,
                   n_planted=16):
    """Float 2-NN cases on the main path's descriptors: ~10% invalid
    columns, planted duplicate candidates (two valid columns holding a
    copy of one query, placed on its predicted position) and a block of
    `n_gated` rows whose every candidate lies outside the gate. Returns
    (cases by xy_mode, planted (query, low column, high column) arrays,
    gated rows)."""
    n1, n2 = d1.shape[0], d2.shape[0]
    d2, xy2 = d2.clone(), xy2.clone()
    q = torch.from_numpy(rng.choice(n1 - n_gated, n_planted,
                                    replace=False)).to(dev)
    cols = torch.from_numpy(rng.choice(n2, 2 * n_planted,
                                       replace=False)).to(dev)
    lo = torch.minimum(cols[:n_planted], cols[n_planted:])
    hi = torch.maximum(cols[:n_planted], cols[n_planted:])
    valid2 = torch.from_numpy(rng.random(n2) > 0.1).to(dev)
    pred = (xy1 + torch.from_numpy(
        rng.normal(scale=8.0, size=(n1, 2)).astype(np.float32)).to(dev))
    gated = torch.arange(n1 - n_gated, n1, device=dev)
    pred[gated] = 1e6
    for c in (lo, hi):
        d2[c] = d1[q]
        valid2[c] = True
        xy2[c] = pred[q]
    rad_q = torch.from_numpy(
        (rng.uniform(20, 80, n1) ** 2).astype(np.float32)).to(dev)
    rad_c = torch.from_numpy(
        (rng.uniform(20, 80, n2) ** 2).astype(np.float32)).to(dev)
    d1, d2, xy2 = d1.contiguous(), d2.contiguous(), xy2.contiguous()
    cases = {0: (d1, d2, valid2), 1: (d1, d2, valid2, pred, rad_q, xy2),
             2: (d1, d2, valid2, pred, rad_c, xy2)}
    return cases, (q, lo, hi), gated


def check_knn2_l2(torch, knn2, cases, planted, gated):
    """Kernel vs plain on the card: |d_k - d_p| <= 1e-5 (1 + |d_p|) for
    d_best and d_second, idx equal wherever the plain gap d_second -
    d_best exceeds 1e-5; the kernel returns the lowest column and
    d_second == d_best on every planted duplicate, and exactly (1e9, 1e9,
    -1) on every gated row. Returns the max |kernel - plain| of the
    distances."""
    q, lo, hi = planted
    max_err = 0.0
    for mode, args in cases.items():
        got = knn2.knn2_l2(*args, xy_mode=mode)
        want = knn2.knn2_l2_plain(*args, xy_mode=mode)
        torch.cuda.synchronize()
        (gd, gs, gi), (wd, ws, wi) = got, want
        for name, g, w in (("d_best", gd, wd), ("d_second", gs, ws)):
            n_bad = int(((g - w).abs() > 1e-5 * (1 + w.abs())).sum())
            if n_bad:
                raise AssertionError(f"knn2_l2 xy_mode={mode}: {name} off "
                                     f"tolerance in {n_bad} rows")
            max_err = max(max_err, float((g.double() - w.double()).abs()
                                         .max()))
        gap = (ws - wd) > 1e-5
        n_bad = int(((gi != wi) & gap).sum())
        if n_bad:
            raise AssertionError(f"knn2_l2 xy_mode={mode}: idx differs in "
                                 f"{n_bad} rows with a gap > 1e-5")
        if not (torch.equal(gi[q], lo.to(torch.int32))
                and torch.equal(gs[q], gd[q])):
            raise AssertionError(f"knn2_l2 xy_mode={mode}: planted "
                                 "duplicates do not return the lowest "
                                 "column with d_second == d_best")
        if mode and not (bool((gd[gated] == 1e9).all())
                         and bool((gs[gated] == 1e9).all())
                         and bool((gi[gated] == -1).all())):
            raise AssertionError(f"knn2_l2 xy_mode={mode}: gated rows not "
                                 "exactly (1e9, 1e9, -1)")
        if int((gi >= 0).sum()) < 100:
            raise AssertionError(f"knn2_l2 xy_mode={mode}: implausibly few "
                                 "neighbours")
    return max_err


def drive_path(torch, kernels, pipe, i1, i2, Kt, dist, gen, truth,
               expected, timed_runs):
    """Drive one path: counters from 0, one (warm) run, counters read
    back and checked against `expected`, the pose held to the accuracy
    bars against `truth` (R, t); then `timed_runs` timed runs, the stage
    split, peak memory and one profiled step. Returns (first run's (corr,
    pose), step record, failures)."""
    from matchinglib_poselib_torch.utils.profiling import HostSyncs

    kernels.reset_launch_counts()
    syncs0 = HostSyncs.count
    corr, pose = pipe.run(i1, i2, Kt, Kt, dist, dist, gen)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    host_syncs = HostSyncs.count - syncs0
    failures = [f"{name} launched {launches[name]} times on the path "
                f"(expected {n})" for name, n in expected.items()
                if launches[name] != n]
    n_corr = int(corr.n)
    n_inl = int(pose.n_inliers)
    rot_err = _rot_deg(truth[0], pose.R.cpu().numpy())
    t_err = _dir_deg(truth[1], pose.t.cpu().numpy())
    if not bool(torch.isfinite(pose.R).all() and torch.isfinite(pose.t).all()
                and torch.isfinite(corr.pts2).all()):
        failures.append("non-finite pose or correspondences")
    if pose.R.shape != (3, 3) or corr.mask.shape != (
            pipe.det_cfg.max_keypoints,):
        failures.append("unexpected output shapes")
    if rot_err >= MAX_ROT_DEG or t_err >= MAX_TANG_DEG:
        failures.append(f"pose off the planted pose: rot {rot_err:.4f} deg, "
                        f"t {t_err:.4f} deg")
    if n_corr < MIN_CORR or n_inl < MIN_INLIERS:
        failures.append(f"too few correspondences/inliers: {n_corr}/{n_inl}")
    record = {"launches": launches, "host_syncs_per_pair": host_syncs,
              "n_corr": n_corr, "n_inliers": n_inl, "rot_err_deg": rot_err,
              "t_err_deg": t_err}
    if timed_runs:
        # timed runs (the generator stream continues: steady-state steps)
        pipe.timer.reset()
        torch.cuda.reset_peak_memory_stats(i1.device)
        step_ms = []
        for _ in range(timed_runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pipe.run(i1, i2, Kt, Kt, dist, dist, gen)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        record.update({
            "runs": timed_runs, "ms_mean": float(np.mean(step_ms)),
            "ms_median": float(np.median(step_ms)),
            "ms_min": float(np.min(step_ms)),
            "stages_ms": {k: v / timed_runs
                          for k, v in pipe.timer.times_ms.items()},
            "peak_mem_mib": torch.cuda.max_memory_allocated(i1.device)
            / 2**20,
        })
        busy_ms, device_ops, prof_wall_ms = _profile_step(
            torch, lambda: pipe.run(i1, i2, Kt, Kt, dist, dist, gen))
        record["profiled_run"] = {"wall_ms": prof_wall_ms,
                                  "device_busy_ms": busy_ms,
                                  "device_ops": device_ops}
    return (corr, pose), record, failures


def cpu_agreement(torch, pipeline, corr, img1, img2, det, desc, match):
    """Share of keypoint slots (mask and xy within 1e-4) and match slots
    (mask; partner within 1e-4 where both keep) on which the port's CPU
    path agrees with the card's run."""
    cpu = pipeline.get_correspondences(
        torch.from_numpy(img1), torch.from_numpy(img2), det, desc, match)
    kp = min(
        float(((a.mask.cpu() == b.mask)
               & ((a.xy.cpu() - b.xy).abs().amax(-1) < 1e-4)).float().mean())
        for a, b in ((corr.kps1, cpu.kps1), (corr.kps2, cpu.kps2)))
    gm, cm = corr.mask.cpu(), cpu.mask
    both = gm & cm
    partners = float(((corr.pts2.cpu() - cpu.pts2).abs().amax(-1)
                      < 1e-4)[both].float().mean())
    return {"keypoints": kp, "matches": float((gm == cm).float().mean()),
            "partners": partners}


def _bound(bytes_moved, time_ops):
    """(bound ms, what bounds it): the larger of the bytes over the HBM
    rate and the operation time."""
    t_bytes = bytes_moved / HBM_BYTES_S * 1e3
    t_ops = time_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from matchinglib_poselib_torch import config as cfg
    from matchinglib_poselib_torch.models import pipeline
    from matchinglib_poselib_torch.ops import features, kernels
    from matchinglib_poselib_torch.ops.kernels import _build, fast_nms, knn2

    smi = _nvidia_smi()
    dev = torch.device("cuda:0")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.default_rng(args.seed)

    # 1. build every kernel of the paths, one nvcc per source in parallel
    t0 = time.perf_counter()
    _build.build()
    build_s = time.perf_counter() - t0
    for name, log in _build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "smem" in line:
                print(f"[ptxas {name}] {line.strip()}", file=sys.stderr)

    det = cfg.DetectorConfig(kind="FAST", max_keypoints=2048,
                             fast_threshold=12.0)
    desc = cfg.DescriptorConfig(kind="ORB")
    match = cfg.MatchingConfig(matcher_name="GMBSOF")
    pose_cfg = cfg.PoseConfig(
        robust=cfg.RobustConfig(batch_hypotheses=96, max_batches=12))
    sift = (cfg.DetectorConfig(kind="SIFT", max_keypoints=2048),
            cfg.DescriptorConfig(kind="SIFT"),
            cfg.MatchingConfig(matcher_name="GMBSOF", gms_filter=True))
    surf = (cfg.DetectorConfig(kind="SURF", max_keypoints=2048),
            cfg.DescriptorConfig(kind="SURF"),
            cfg.MatchingConfig(matcher_name="GMBSOF"))
    img1, img2, K, R_true, t_true = render_scene(args.seed)
    i1 = torch.from_numpy(img1).to(dev)
    i2 = torch.from_numpy(img2).to(dev)
    thr = det.fast_threshold / 255.0

    # 2. K1: fused FAST+NMS vs plain at the main path's shapes
    one = i1[None].contiguous()
    two = torch.stack([i1, i2]).contiguous()
    k1_err = 0.0
    k1_ties = 0
    for imgs in (one, two):
        err, ties = check_fast_nms(torch, fast_nms, imgs, thr, det.nms_radius)
        k1_err, k1_ties = max(k1_err, err), k1_ties + ties
    k1 = functools.partial(fast_nms.fast_nms_score, one, thr, det.nms_radius)
    k1_plain = functools.partial(fast_nms.fast_nms_score_plain, one, thr,
                                 det.nms_radius)
    k1_ms, k1_plain_ms = _cuda_ms(torch, k1), _cuda_ms(torch, k1_plain)
    k1_dev_ms = _device_ms(torch, k1)
    k1_plain_dev_ms = _device_ms(torch, k1_plain)

    # 3. K2a: fused 2-NN vs plain at 2048 x 2048 on the scene's descriptors
    corr = pipeline.get_correspondences(i1, i2, det, desc, match)
    d1, _ = features.compute_descriptors(i1, corr.kps1, desc,
                                         features.detector_bands(det))
    d2, _ = features.compute_descriptors(i2, corr.kps2, desc,
                                         features.detector_bands(det))
    cases = knn2_inputs(torch, rng, d1, d2, corr.kps1.xy, corr.kps2.xy, dev)
    k2_err = check_knn2(torch, knn2, cases)
    k2 = {m: functools.partial(knn2.knn2, *cases[m], xy_mode=m)
          for m in (0, 1)}
    k2_plain = {m: functools.partial(knn2.knn2_plain, *cases[m], xy_mode=m)
                for m in (0, 1)}
    k2_ms = {m: _cuda_ms(torch, f) for m, f in k2.items()}
    k2_plain_ms = {m: _cuda_ms(torch, f) for m, f in k2_plain.items()}
    k2_dev_ms = {m: _device_ms(torch, f) for m, f in k2.items()}
    k2_plain_dev_ms = {m: _device_ms(torch, f) for m, f in k2_plain.items()}

    # 3b. K2b: float 2-NN vs plain on the scene's SIFT and M-SURF
    # descriptors (the float paths' shapes)
    k2b_err = 0.0
    k2b = {}
    for name, (dcfg, ccfg, _) in (("sift", sift), ("msurf", surf)):
        kp1 = features.detect_keypoints(i1, dcfg)
        kp2 = features.detect_keypoints(i2, dcfg)
        f1, _ = features.compute_descriptors(i1, kp1, ccfg)
        f2, _ = features.compute_descriptors(i2, kp2, ccfg)
        fcases, planted, gated = knn2_l2_inputs(torch, rng, f1, f2, kp1.xy,
                                                kp2.xy, dev)
        k2b_err = max(k2b_err, check_knn2_l2(torch, knn2, fcases, planted,
                                             gated))
        (s1, depth), s2 = f1.shape, f2.shape[0]
        rec = {"shape": [s1, s2, depth]}
        rec["bound_ms"], rec["bound_by"] = _bound(
            (s1 + s2) * depth * 4 + s2 + s1 * 12,
            (2 * s1 * s2 * depth + 2 * (s1 + s2) * depth + 4 * s1 * s2)
            / FP32_FLOP_S)
        for m in (0, 1):
            fk = functools.partial(knn2.knn2_l2, *fcases[m], xy_mode=m)
            fp = functools.partial(knn2.knn2_l2_plain, *fcases[m], xy_mode=m)
            rec[m] = {"ms": _cuda_ms(torch, fk),
                      "plain_ms": _cuda_ms(torch, fp),
                      "device_ms": _device_ms(torch, fk),
                      "plain_device_ms": _device_ms(torch, fp)}
        k2b[name] = rec

    Kt = torch.from_numpy(K).to(dev)
    dist = torch.zeros(5, device=dev)
    failures = []
    steps = []

    def path(name, cfgs, expected, timed_runs):
        pipe = pipeline.StereoPipeline(*cfgs, pose_cfg)
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        (c, _), rec, fails = drive_path(torch, kernels, pipe, i1, i2, Kt,
                                        dist, gen, (R_true, t_true),
                                        expected, timed_runs)
        failures.extend(f"{name}: {f}" for f in fails)
        return c, rec

    # 4. the flagship path on the card: counters from 0, one run, read back
    corr, rec = path("FAST/ORB", (det, desc, match),
                     {"fast_nms": 2, "knn2": 2}, TIMED_RUNS)
    launches = rec["launches"]
    # 5. the port's CPU path on the same pair agrees with the card's
    rec["cpu_agree"] = cpu_agreement(torch, pipeline, corr, img1, img2, det,
                                     desc, match)
    steps.append(("FAST t=12 / 2048 kp / ORB / GMBSOF / 96x12 5pt USAC",
                  rec))
    # 4b. SIFT/SIFT + GMBSOF + GMS
    corr, rec = path("SIFT/SIFT+GMS", sift,
                     {"knn2_l2": 2, "knn2": 0, "fast_nms": 0}, TIMED_RUNS)
    sift_launches = rec["launches"]
    rec["cpu_agree"] = cpu_agreement(torch, pipeline, corr, img1, img2,
                                     *sift)
    steps.append(("SIFT / 2048 kp / SIFT / GMBSOF + GMS / 96x12 5pt USAC",
                  rec))
    # 4c. SURF/SURF + GMBSOF, one run
    _, rec = path("SURF/SURF", surf, {"knn2_l2": 2, "knn2": 0,
                                      "fast_nms": 0}, 0)
    steps.append(("SURF / 2048 kp / M-SURF / GMBSOF / 96x12 5pt USAC", rec))
    for c_name, rec in steps:
        agree = rec.get("cpu_agree")
        if agree and min(agree.values()) < 0.99:
            failures.append(f"{c_name}: card vs CPU slots {agree}")

    # bounds from this run's shapes
    n_px = HEIGHT * WIDTH
    k1_bound = _bound(2 * n_px * 4, n_px * 128 / FP32_FLOP_S)
    n1 = n2 = det.max_keypoints
    k2_bound = _bound((n1 + n2) * 32 + n2 + n1 * 12,
                      n1 * n2 * 8 / (POPC_PER_CLK_SM * n_sm * SM_CLOCK_HZ))
    kernels_line = {"kernels": [
        {"name": "fast_nms", "route": "cuda",
         "source": "matchinglib_poselib_torch/csrc/fast_nms.cu",
         "replaces": "matchinglib_poselib_tpu/ops/pallas/fast.py:113",
         "launches": launches["fast_nms"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms,
         "bound_ms": k1_bound[0], "bound_by": k1_bound[1],
         "library_ms": None, "tie_mismatches": k1_ties,
         "device_ms": k1_dev_ms, "plain_device_ms": k1_plain_dev_ms},
        {"name": "knn2", "route": "cuda",
         "source": "matchinglib_poselib_torch/csrc/knn2.cu",
         "replaces": "matchinglib_poselib_tpu/ops/pallas/knn.py:131",
         "launches": launches["knn2"], "max_abs_err": k2_err,
         "ms": k2_ms[0], "plain_ms": k2_plain_ms[0],
         "bound_ms": k2_bound[0], "bound_by": k2_bound[1],
         "library_ms": None,
         "device_ms": k2_dev_ms[0], "plain_device_ms": k2_plain_dev_ms[0],
         "ms_guided": k2_ms[1], "plain_ms_guided": k2_plain_ms[1],
         "device_ms_guided": k2_dev_ms[1],
         "plain_device_ms_guided": k2_plain_dev_ms[1]},
        {"name": "knn2_l2", "route": "cuda",
         "source": "matchinglib_poselib_torch/csrc/knn2_l2.cu",
         "replaces": "matchinglib_poselib_tpu/ops/pallas/knn.py:51",
         "launches": sift_launches["knn2_l2"], "max_abs_err": k2b_err,
         "ms": k2b["sift"][0]["ms"], "plain_ms": k2b["sift"][0]["plain_ms"],
         "device_ms": k2b["sift"][0]["device_ms"],
         "plain_device_ms": k2b["sift"][0]["plain_device_ms"],
         "bound_ms": k2b["sift"]["bound_ms"],
         "bound_by": k2b["sift"]["bound_by"], "library_ms": None,
         "by_shape": k2b},
    ]}
    print(json.dumps(kernels_line))
    for c_name, rec in steps:
        print(json.dumps({"step": {"config": c_name, "image": [HEIGHT, WIDTH],
                                   "seed": args.seed, "build_s": build_s,
                                   **rec}}))
    if failures:
        for f in failures:
            print(f"chip_smoke: FAILED: {f}", file=sys.stderr)
        return 1
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
