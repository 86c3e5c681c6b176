"""Drive the PyTorch port's main paths on one CUDA card and check them.

    python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero):
  1. build the CUDA kernels from ``matchinglib_poselib_torch/csrc`` (one
     nvcc per source, in parallel);
  2. fused FAST+NMS kernel vs its plain version at every pixel, border
     included, against the plain version of the input zero-padded by
     3 + r: on the scene's images at (1, 512, 1392) and (2, 512, 1392) and
     at the ragged shapes and radii of ``FAST_NMS_PADDED``; equal up to f32
     ties inside an NMS window (0 expected); radius 6 and a negative
     threshold must raise on the card; one kernel per call;
  3. fused binary 2-NN kernel (tensor-core b1 AND-popc product) vs its
     plain version at 2048 x 2048 on the scene's ORB descriptors, xy_mode
     0, 1 and 2, with ~10% invalid columns and planted ties: bit-exact;
     and at the ragged shapes ``KNN2_RAGGED`` (random words, planted ties,
     rows whose candidates are all gated or all invalid: exactly (1e9,
     1e9, -1));
  3b. fused float 2-NN kernel vs its plain version (cuBLAS fp32, TF32
     off) on the scene's SIFT (2048 x 2048 x 128) and M-SURF (x 64)
     descriptors, xy_mode 0, 1 and 2, ~10% invalid columns, planted
     duplicate candidates and a block of fully gated rows: distances
     within 1e-5 (1 + |d|), idx equal where the gap exceeds 1e-5, the
     duplicates' lowest column and the gated rows' (1e9, 1e9, -1) exact;
     and the same checks at the ragged shapes ``KNN2_L2_RAGGED`` x D =
     128, 64, 67 (random unit rows, duplicates inside one tile and across
     the first and last column slices, all-invalid and all-gated rows);
  4. ``StereoPipeline.run`` at the flagship config (FAST t=12, 2048
     keypoints, ORB, GMBSOF, 96 x 12 five-point hypotheses) on a seeded
     synthetic 1392x512 stereo scene with a planted pose: one warm run,
     then timed runs; launch counters must show both kernels on the path;
     the pose must meet the accuracy bars; the profiled step's device ops
     at most 3% over the 31,143 of the single-pair path before the pair
     axis (``FLAGSHIP_DEVICE_OPS``), its host syncs at most 2 over the 24
     measured with the closed-form LM Jacobian (``FLAGSHIP_HOST_SYNCS``);
  5. the port's CPU path on the same pair: keypoint and match slots agree
     with the card's;
  4b. the same at SIFT/SIFT + GMBSOF + GMS (2048 keypoints, 96 x 12):
     warm run, timed runs, the float 2-NN kernel launched twice and no
     other, accuracy bars, the CPU path's slots agree with the card's;
  4c. SURF/SURF + GMBSOF, one run: the float 2-NN kernel twice, accuracy
     bars;
  4d. the pose menu at the flagship config (``pose_menu``): AutoTh,
     Halign, stereo BA (20 iterations) and the Kneip polish, each with
     explicit seeded sample streams (``pose_streams``): warm run, timed
     runs, K1 and K2a twice each, accuracy bars (Halign: the JAX
     package's 3 / 10 deg, whichever branch decided), then the pose stage
     again on the CPU from the card's correspondences and the same
     streams (``check_pose_card_vs_cpu``); ``bundle_adjust`` and the
     eigensolver's Newton loop on the card under
     ``torch.cuda.set_sync_debug_mode("error")`` (``check_no_host_sync``);
  6. the stream (``stream_phase``): ``StereoRefine`` at the
     ``poselib-test --stereoRef`` defaults (``stereo_ref_config``: a pool
     of 30,000) over a seeded 10-frame sequence of the scene
     (``render_sequence``; frame 7 a bad pair: its right image shows other
     textures), fed by the flagship front
     end with seeded streams (``SeededStreams``): frame 1 init, every good
     frame refined or robust, the bad one skipped (pose unchanged) or
     robust, every accepted pose within the accuracy bars, the pool past
     1,000, K1 and K2a 2 launches each per frame; frames 1-6 again on the
     CPU from the card's correspondences (same states, pools within 1%,
     0.1 / 0.5 deg); every frame again at a pool of 1,024 on the card and
     on the CPU, which must fill the pool (eviction, the robust cadence's
     full-pool branch) and agree as frames 1-6 do (``stream_full_pool``);
     the checkpoint after frame 4 resumed on the card
     (same states, R and t within 1e-6); one refined and one robust frame
     profiled;
  7. the batch (``batch_phase``): ``StereoPipeline.run_batch`` at the
     flagship config on the sequence's first 8 pairs (the bad pair
     among them) with seeded explicit streams: K1 launched once for the
     batch and K2a twice per pair; K1 against its zero-padded plain
     version at every pixel of the batch's (16, 512, 1392) stack; the 7
     good pairs within the accuracy
     bars; every pair equal to ``run`` of that pair on the card with the
     same streams (keypoint and match slots 100%, inlier masks equal,
     0.01 / 0.05 deg); the batch's pose stage on the CPU from the card's
     correspondences within phase 4d's bars; host syncs per batch at
     most the sum, over the runs of each data-dependent loop, of the most
     iterations any pair takes there alone, plus 2; the pose stage's
     device ops at most 1.5x the costliest pair's alone; timed batches
     beside the 8 pairs run one by one.

Prints a JSON ``kernels`` line, one JSON ``step`` line per path, the
card's name and power limit, and as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
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
# phase 4d: timed runs per pose branch; card vs CPU on the pose stage
# (tests/test_torch_pipeline.py's _check: 0.1 deg, 0.5 deg), inlier slots,
# AutoTh's threshold
POSE_TIMED_RUNS = 5
POSE_ROT_DEG, POSE_TANG_DEG = 0.1, 0.5
POSE_INLIER_AGREE = 0.99
AUTOTH_TH_RTOL = 1e-4
# published H100 SXM peaks (NVIDIA H100 datasheet; CUDA C++
# Programming Guide throughput table, compute capability 9.0)
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12
SM_CLOCK_HZ = 1.98e9  # maximum boost clock
POPC_PER_CLK_SM = 16
INT32_PER_CLK_SM = 64  # 32-bit integer add, multiply-add, min / max, LOP;
#                        fp32 compare
FP32_PER_CLK_SM = 128  # fp32 add, multiply
# No peak is published for the b1 tensor-core product: the rate that
# chip_probes/mma_probe.py measures on an H100, 0.60 m16n8k256 BMMA per
# clock per SM, each 2 x 16 x 8 x 256 ops
BMMA_OPS_PER_CLK_SM = 0.60 * 2 * 16 * 8 * 256
# K2a's epilogue per pair, unguided and guided: one IMAD builds the key,
# three min / max update the top-2; the gate of xy_mode 1 and 2 adds
# FSETP and a LOP (integer rate) and 2 FADD, 2 FMUL, FADD (fp32 rate)
KNN2_INT_OPS = (4, 6)
KNN2_FP32_OPS = (0, 5)
# K2b's gate per pair: 2 FADD, 2 FMUL, FADD at the fp32 rate
KNN2_L2_GATE_FP32_OPS = 5
# K1 per pixel, at its least. fp32 pipe: 16 FADD for the ring differences
# d, 16 for |d| - t (the relu's argument on either side), 32 predicated
# FADD for the relu sums and 32 for the mask bits (2^s under the same
# predicate), 2 to turn the masks into integers, and 2 IMAD to double the
# masks (IMAD issues on the FMA pipe). Compare / integer pipe: 32 FSETP
# (one per side and sample serves the sum and the mask bit), 16 SHF / LOP
# for the arc test's 4 rounds on both sides and 2 for its combined test,
# FMNMX and a select for the score, 3 for the keep test; plus the
# (2r+1)^2 window max, `k1_window_ops`
K1_FP32_OPS = 100
K1_ALU_OPS = 55


def k1_window_ops(radius):
    """Max ops per pixel of a (2r+1)^2 window max at its least: separable,
    2r per axis, or a running max (van Herk / Gil-Werman), about 3 per axis
    whatever r is."""
    return min(4 * radius, 6)


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


def _scene_setup(seed: int, width: int, height: int):
    """The seeded scene every renderer shares: (rng, K, R, t, planes),
    with K_FULL scaled to the size and the planted rig X2 = R X1 + t (a
    KITTI-like 0.54 m baseline along -x, a small forward part, a ~1.5 deg
    rotation); `rng` continues into the pixel noise."""
    rng = np.random.default_rng(seed)
    K = K_FULL.copy()
    K[0] *= width / WIDTH
    K[1] *= height / HEIGHT
    R = _rot((0.15, 1.0, 0.1), 1.5)
    t = np.array([-0.54, 0.01, 0.04])
    return rng, K, R, t, _planes(rng)


def render_scene(seed: int = 0, width: int = WIDTH, height: int = HEIGHT,
                 noise: float = 0.005):
    """Seeded stereo pair with a planted pose.

    Returns (img1, img2, K, R, t): float32 images (H, W) in [0, 1], the
    shared intrinsics, and the planted relative pose X2 = R X1 + t.
    """
    rng, K, R, t, planes = _scene_setup(seed, width, height)
    img1 = _render(planes, K, np.eye(3), np.zeros(3), width, height, rng,
                   noise)
    img2 = _render(planes, K, R, t, width, height, rng, noise)
    return img1, img2, K.astype(np.float32), R, t


def render_sequence(seed: int = 0, frames: int = 10, width: int = WIDTH,
                    height: int = HEIGHT, noise: float = 0.005):
    """Seeded stereo sequence of the same scene and rig: camera 1 moves
    0.25 m forward and yaws 0.2 deg per frame, the rig's relative pose
    stays the planted one, the pixel noise is fresh per frame, one sample
    per pixel. Frame STREAM_BAD_FRAME (1-based) is a bad pair: its right
    image shows the same planes with other textures (a swapped camera
    feed), so its matches fit no rigid motion. (Another frame's right
    image of this static scene would not do: with the left image of a
    frame 1.25 m on it is a consistent two-view pair, and the stream
    rightly reinitializes on it.) Returns ([(img1, img2), ...], K, R,
    t)."""
    rng, K, R, t, planes = _scene_setup(seed, width, height)
    pairs = []
    for f in range(frames):
        R1 = _rot((0.0, 1.0, 0.0), 0.2 * f)
        t1 = -R1 @ np.array([0.0, 0.0, 0.25 * f])
        img1 = _render(planes, K, R1, t1, width, height, rng, noise, ss=1)
        img2 = _render(planes, K, R @ R1, R @ t1 + t, width, height, rng,
                       noise, ss=1)
        if f + 1 == STREAM_BAD_FRAME:
            other = np.random.default_rng(seed + 1)
            img2 = _render(_planes(other), K, R @ R1, R @ t1 + t, width,
                           height, other, noise, ss=1)
        pairs.append((img1, img2))
    return pairs, K.astype(np.float32), R, t


# ---------------------------------------------------------------------------
# measurement helpers
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def _sequence(seed: int):
    """``render_sequence(seed, STREAM_FRAMES)``, rendered once for phases 6
    and 7."""
    return render_sequence(seed, STREAM_FRAMES)


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


def _device_profile(torch, fn, iters=10, tries=3):
    """(device ms, device ops) per call of `fn`, from torch.profiler: the
    summed time of every kernel it launches, which unlike CUDA events
    around back-to-back calls leaves out the gaps where the card waits for
    the host to launch, and the number of those kernels. Now and then a
    trace records no kernel at all, or drops one (a count that is not a
    whole number per call); it is taken again, up to `tries` traces. If
    none records a kernel, (None, None) (not measured); if each drops one,
    the last trace's numbers."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    out = None, None
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        device = [e for e in prof.key_averages()
                  if e.device_type.name == "CUDA"]
        ms = sum(e.self_device_time_total for e in device) / 1e3 / iters
        count = sum(e.count for e in device)
        if ms > 0:
            out = ms, count / iters
            if count % iters == 0:
                break
    return out


def _device_ms(torch, fn, iters=10, tries=3):
    """Device ms per call of `fn` (`_device_profile`)."""
    return _device_profile(torch, fn, iters, tries)[0]


def _profile_step(torch, step):
    """One step under torch.profiler: (device-busy ms = summed device
    time of its kernels and copies, number of device ops, wall ms of the
    profiled step, which the profiler itself slows). Device activity only:
    the host ops' events would double what ``key_averages`` sorts (~80 us
    per event on the host), and the device numbers do not need them."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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


def check_fast_nms(torch, fast_nms, imgs, threshold, radius,
                   min_corners=1000):
    """Kernel vs plain on the card at every pixel, against the plain
    version of the input zero-padded by 3 + radius and cropped back (the
    kernel reads pixels outside the image as 0, the plain version wraps;
    3 + radius or more from the border the two references agree). Equal
    except where an NMS decision differs because another pixel of the
    window holds the same score (an f32 tie). Returns (max |kernel -
    plain|, number of tie mismatches)."""
    out = fast_nms.fast_nms_score(imgs, threshold, radius)
    p = 3 + radius
    ref = fast_nms.fast_nms_score_plain(
        torch.nn.functional.pad(imgs, (p, p, p, p)), threshold,
        radius)[:, p:-p, p:-p]
    o, r = out.cpu().numpy(), ref.cpu().numpy()
    max_err = float(np.abs(o - r).max())
    bad = np.argwhere(o != r)
    for b, y, x in bad:
        v = max(o[b, y, x], r[b, y, x])
        win = (slice(max(0, y - radius), y + radius + 1),
               slice(max(0, x - radius), x + radius + 1))
        near = np.abs(np.maximum(o[b][win], r[b][win]) - v) \
            <= 1e-6 * max(v, 1.0)
        # one side suppressed it, and a neighbour (the pixel itself is one
        # of `near`) holds the same score
        if min(o[b, y, x], r[b, y, x]) != 0.0 or int(near.sum()) < 2:
            raise AssertionError(
                f"fast_nms {tuple(imgs.shape)} r={radius}: non-tie mismatch "
                f"at {(int(b), int(y), int(x))}: kernel {o[b, y, x]} "
                f"plain {r[b, y, x]}")
    if int((o > 0).sum()) < min_corners:
        raise AssertionError(f"fast_nms {tuple(imgs.shape)} r={radius}: "
                             "implausibly few corners")
    return max_err, len(bad)


# K1's every-pixel cases (shape, radius): ragged shapes at the main path's
# radius, the main path's shapes (None: the scene's images), and one ragged
# shape at every other radius the kernel is built for
FAST_NMS_PADDED = ((((1, 37, 53), 3), ((2, 70, 129), 3), ((3, 33, 200), 3),
                    (None, 3))
                   + tuple(((2, 70, 129), r) for r in (0, 1, 2, 4, 5)))


def check_fast_nms_padded(torch, fast_nms, rng, scene, threshold, dev,
                          scene_min_corners=1000):
    """`check_fast_nms` over `FAST_NMS_PADDED`: uniform random images at
    the ragged shapes, the scene's (1, H, W) and (2, H, W) stacks in
    `scene`. Returns (max |kernel - plain|, ties) over the scene's stacks
    and over every case."""
    scene_err, scene_ties, max_err, ties = 0.0, 0, 0.0, 0
    for shape, radius in FAST_NMS_PADDED:
        if shape is None:
            cases = [(imgs, scene_min_corners) for imgs in scene]
        else:
            cases = [(torch.from_numpy(rng.random(shape, np.float32))
                      .to(dev), 10)]
        for imgs, min_corners in cases:
            err, n = check_fast_nms(torch, fast_nms, imgs, threshold, radius,
                                    min_corners=min_corners)
            max_err, ties = max(max_err, err), ties + n
            if shape is None:
                scene_err, scene_ties = max(scene_err, err), scene_ties + n
    return (scene_err, scene_ties), (max_err, ties)


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


# K2a's ragged shapes (n1, n2): a single row, n2 inside one 64-column
# tile, more rows than columns, and an odd size past a power of two
KNN2_RAGGED = ((1, 5), (17, 70), (70, 17), (2047, 2049))


def knn2_ragged_cases(torch, rng, dev):
    """K2a cases at the ragged shapes, xy_mode 0, 1 and 2: random words,
    ~10% invalid columns, planted ties where n2 allows, and the last
    quarter of the rows (at least one) predicted far outside every gate;
    plus, at 17 x 70, every column invalid. Returns [(label, xy_mode,
    args, rows that must come out exactly (1e9, 1e9, -1))]."""
    def words(n):
        return torch.from_numpy(rng.integers(-2**31, 2**31, (n, 8),
                                             dtype=np.int64)
                                .astype(np.int32)).to(dev)

    cases = []
    for (n1, n2), all_invalid in ([(s, False) for s in KNN2_RAGGED]
                                  + [((17, 70), True)]):
        d1, d2 = words(n1), words(n2)
        if n2 >= 4:  # equal candidates, and copies of a query
            d2[n2 - 1] = d2[1]
            d2[n2 - 2] = d2[0] = d1[0]
        valid2 = torch.from_numpy(rng.random(n2) > 0.1).to(dev)
        if all_invalid:
            valid2[:] = False
        pred = torch.from_numpy(
            rng.uniform(0, 100, (n1, 2)).astype(np.float32)).to(dev)
        pts2 = torch.from_numpy(
            rng.uniform(0, 100, (n2, 2)).astype(np.float32)).to(dev)
        gated = torch.arange(n1 - max(1, n1 // 4), n1, device=dev)
        pred[gated] = 1e6
        for mode in (0, 1, 2):
            rad2 = torch.from_numpy((rng.uniform(20, 80, n1 if mode == 1
                                                 else n2) ** 2)
                                    .astype(np.float32)).to(dev)
            args = (d1, d2, valid2) + ((pred, rad2, pts2) if mode else ())
            faulted = (torch.arange(n1, device=dev) if all_invalid
                       else gated if mode else gated[:0])
            label = (f"{n1}x{n2}" + (" all invalid" if all_invalid else ""))
            cases.append((label, mode, args, faulted))
    return cases


def check_knn2_ragged(torch, knn2, cases):
    """Kernel vs plain on the card at the ragged shapes: bit-exact on all
    three outputs, and exactly (1e9, 1e9, -1) on every row whose
    candidates are all invalid or all gated."""
    for label, mode, args, faulted in cases:
        got = knn2.knn2(*args, xy_mode=mode)
        want = knn2.knn2_plain(*args, xy_mode=mode)
        for name, g, w in zip(("d_best", "d_second", "idx"), got, want):
            if not torch.equal(g, w):
                raise AssertionError(
                    f"knn2 {label} xy_mode={mode}: {name} differs in "
                    f"{int((g != w).sum())} rows")
        d, s, i = (x[faulted] for x in got)
        if not (bool((d == 1e9).all()) and bool((s == 1e9).all())
                and bool((i == -1).all())):
            raise AssertionError(f"knn2 {label} xy_mode={mode}: faulted rows "
                                 "not exactly (1e9, 1e9, -1)")


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
    q, lo, _ = planted
    max_err = 0.0
    for mode, args in cases.items():
        got = knn2.knn2_l2(*args, xy_mode=mode)
        want = knn2.knn2_l2_plain(*args, xy_mode=mode)
        max_err = max(max_err, _check_l2(
            torch, f"xy_mode={mode}", got, want, (q, lo),
            gated if mode else gated[:0]))
        if int((got[2] >= 0).sum()) < 100:
            raise AssertionError(f"knn2_l2 xy_mode={mode}: implausibly few "
                                 "neighbours")
    return max_err


def _check_l2(torch, label, got, want, planted, faulted):
    """One K2b result against its plain version: |d_k - d_p| <= 1e-5 (1 +
    |d_p|) for d_best and d_second, idx equal wherever the plain gap
    exceeds 1e-5, the lowest column and d_second == d_best on every
    planted (query, low column), exactly (1e9, 1e9, -1) on every faulted
    row. Returns the max |kernel - plain| of the distances."""
    torch.cuda.synchronize()
    (gd, gs, gi), (wd, ws, wi) = got, want
    max_err = 0.0
    for name, g, w in (("d_best", gd, wd), ("d_second", gs, ws)):
        n_bad = int(((g - w).abs() > 1e-5 * (1 + w.abs())).sum())
        if n_bad:
            raise AssertionError(f"knn2_l2 {label}: {name} off tolerance in "
                                 f"{n_bad} rows")
        max_err = max(max_err, float((g.double() - w.double()).abs().max()))
    gap = (ws - wd) > 1e-5
    n_bad = int(((gi != wi) & gap).sum())
    if n_bad:
        raise AssertionError(f"knn2_l2 {label}: idx differs in {n_bad} rows "
                             "with a gap > 1e-5")
    q, lo = planted
    if not (torch.equal(gi[q], lo.to(torch.int32))
            and torch.equal(gs[q], gd[q])):
        raise AssertionError(f"knn2_l2 {label}: planted duplicates do not "
                             "return the lowest column with d_second == "
                             "d_best")
    if not (bool((gd[faulted] == 1e9).all())
            and bool((gs[faulted] == 1e9).all())
            and bool((gi[faulted] == -1).all())):
        raise AssertionError(f"knn2_l2 {label}: faulted rows not exactly "
                             "(1e9, 1e9, -1)")
    return max_err


# K2b's ragged shapes (n1, n2), as K2a's, at each of these depths: SIFT,
# M-SURF, and one that is not a multiple of 4 (4-byte copies)
KNN2_L2_RAGGED = KNN2_RAGGED
KNN2_L2_DEPTHS = (128, 64, 67)


def knn2_l2_ragged_cases(torch, rng, dev):
    """K2b cases at the ragged shapes and depths, xy_mode 0, 1 and 2:
    random unit rows, ~10% invalid columns, the last quarter of the rows
    predicted far outside every gate; planted duplicates of a query (two
    valid columns on its predicted position), one pair inside one tile of
    the first column slice and one pair across the first and the last
    slice; plus, at 17 x 70, every column invalid, or (xy_mode 1 and 2)
    every row gated. Returns [(label, xy_mode, args, planted (queries, low
    columns), rows that must come out exactly (1e9, 1e9, -1))]."""
    def unit(n, depth):
        x = rng.normal(size=(n, depth)).astype(np.float32)
        return torch.from_numpy(x / np.linalg.norm(x, axis=1, keepdims=True))

    cases = []
    shapes = ([(s, None) for s in KNN2_L2_RAGGED]
              + [((17, 70), "invalid"), ((17, 70), "gated")])
    for depth in KNN2_L2_DEPTHS:
        for (n1, n2), fault in shapes:
            d1, d2 = unit(n1, depth), unit(n2, depth)
            valid2 = torch.from_numpy(rng.random(n2) > 0.1)
            pred = torch.from_numpy(
                rng.uniform(0, 100, (n1, 2)).astype(np.float32))
            pts2 = torch.from_numpy(
                rng.uniform(0, 100, (n2, 2)).astype(np.float32))
            planted = ([(0, 0, n2 - 1)] if n1 == 1
                       else [(0, 1, 2), (1, 0, n2 - 1)])
            for q, lo, hi in planted:
                d2[lo] = d2[hi] = d1[q]
                valid2[lo] = valid2[hi] = True
                pts2[lo] = pts2[hi] = pred[q]
            gated = torch.arange(n1 - n1 // 4, n1)
            pred[gated] = 1e6
            if fault == "invalid":
                valid2[:] = False
            elif fault == "gated":
                pred[:] = 1e6
            if fault:
                planted = []
            q = torch.tensor([p[0] for p in planted], dtype=torch.int64)
            lo = torch.tensor([p[1] for p in planted], dtype=torch.int64)
            d1, d2, valid2, pred, pts2 = (
                x.to(dev) for x in (d1, d2, valid2, pred, pts2))
            for mode in (0, 1, 2) if fault != "gated" else (1, 2):
                rad2 = torch.from_numpy(
                    (rng.uniform(20, 80, n1 if mode == 1 else n2) ** 2)
                    .astype(np.float32)).to(dev)
                args = (d1, d2, valid2) + ((pred, rad2, pts2) if mode else ())
                faulted = (torch.arange(n1) if fault
                           else gated if mode else gated[:0])
                label = (f"{n1}x{n2}x{depth}"
                         + (f" all {fault}" if fault else "")
                         + f" xy_mode={mode}")
                cases.append((label, mode, args, (q.to(dev), lo.to(dev)),
                              faulted.to(dev)))
    return cases


def check_knn2_l2_ragged(torch, knn2, cases):
    """K2b vs plain on the card at the ragged shapes (`_check_l2`).
    Returns the max |kernel - plain| of the distances."""
    max_err = 0.0
    for label, mode, args, planted, faulted in cases:
        got = knn2.knn2_l2(*args, xy_mode=mode)
        want = knn2.knn2_l2_plain(*args, xy_mode=mode)
        max_err = max(max_err, _check_l2(torch, label, got, want, planted,
                                         faulted))
    return max_err


def drive_path(torch, kernels, pipe, i1, i2, Kt, dist, gen, truth,
               expected, timed_runs, streams=None,
               bars=(MAX_ROT_DEG, MAX_TANG_DEG)):
    """Drive one path: counters from 0, one (warm) run, counters read
    back and checked against `expected`, the pose held to the accuracy
    `bars` (rotation, translation direction, deg) against `truth` (R, t);
    then `timed_runs` timed runs, the stage split, peak memory and one
    profiled step. `streams`: explicit sample streams for ``run`` (else
    `gen` draws them). Returns (first run's (corr, pose), step record,
    failures)."""
    from matchinglib_poselib_torch.utils.profiling import HostSyncs

    streams = streams or {}

    def run():
        return pipe.run(i1, i2, Kt, Kt, dist, dist, gen, **streams)

    kernels.reset_launch_counts()
    syncs0 = HostSyncs.count
    t0 = time.perf_counter()
    corr, pose = run()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
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
    if rot_err >= bars[0] or t_err >= bars[1]:
        failures.append(f"pose off the planted pose: rot {rot_err:.4f} deg, "
                        f"t {t_err:.4f} deg")
    if n_corr < MIN_CORR or n_inl < MIN_INLIERS:
        failures.append(f"too few correspondences/inliers: {n_corr}/{n_inl}")
    record = {"launches": launches, "host_syncs_per_pair": host_syncs,
              "n_corr": n_corr, "n_inliers": n_inl, "rot_err_deg": rot_err,
              "t_err_deg": t_err, "warm_s": warm_s}
    if timed_runs:
        # timed runs (the generator stream continues: steady-state steps)
        pipe.timer.reset()
        torch.cuda.reset_peak_memory_stats(i1.device)
        step_ms = []
        for _ in range(timed_runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
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
        t0 = time.perf_counter()
        busy_ms, device_ops, prof_wall_ms = _profile_step(torch, run)
        record["profiled_s"] = time.perf_counter() - t0
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


def pose_menu(cfg):
    """Phase 4d's branches: (name, PoseConfig changes, accuracy bars)."""
    return (
        ("AutoTh", dict(auto_th=True), (MAX_ROT_DEG, MAX_TANG_DEG)),
        # the JAX package's own bars for Halign
        # (tests/test_pose_branches.py:132)
        ("Halign", dict(use_halign=True), (3.0, 10.0)),
        ("BA", dict(ba=cfg.BAConfig(enabled=True, iterations=20)),
         (MAX_ROT_DEG, MAX_TANG_DEG)),
        ("Kneip", dict(refine=cfg.RefinementConfig(
            solver=cfg.MinimalSolver.KNEIP)), (MAX_ROT_DEG, MAX_TANG_DEG)),
    )


def pose_streams(torch, robust, pose_cfg, seed):
    """Seeded sample streams on the CPU for one pose branch, in the shapes
    ``estimate_pose`` documents (k = 5 for the 5pt solver)."""
    g = torch.Generator().manual_seed(seed)
    e_shape, d_shape = robust.sample_shapes(pose_cfg.robust)

    def u(*shape):
        return torch.rand(shape, generator=g)

    if pose_cfg.use_halign:
        return {"plane_uniforms": u(pose_cfg.halign.max_planes,
                                    *e_shape[:2], 4),
                "uniforms": u(*e_shape)}
    degen = u(*d_shape)
    if pose_cfg.auto_th:
        return {"uniforms": u(robust.AUTOTH_ROUNDS, *e_shape),
                "degen_uniforms": degen}
    return {"uniforms": u(*e_shape), "degen_uniforms": degen}


def _autoth_on(robust, geo, cfg, corr, K, dist, streams, device):
    """AutoTh alone on `device` from the pixel correspondences, as
    ``estimate_pose`` calls it: (adapted threshold, rounds)."""
    from matchinglib_poselib_torch.config import MAX_PIX_TH, MIN_PIX_TH

    K, dist = K.to(device), dist.to(device)
    x1 = geo.undistort_oulu(geo.img_to_cam(corr.pts1.to(device), K), dist)
    x2 = geo.undistort_oulu(geo.img_to_cam(corr.pts2.to(device), K), dist)
    f_mean = 0.25 * (K[0, 0] + K[1, 1] + K[0, 0] + K[1, 1])
    th = cfg.robust.threshold_px / f_mean
    res = robust.estimate_essential_autoth(
        x1, x2, corr.mask.to(device).float(), corr.quality.to(device),
        cfg.robust, threshold_sq=th * th, min_threshold=MIN_PIX_TH / f_mean,
        max_threshold=MAX_PIX_TH / f_mean,
        uniforms=streams["uniforms"].to(device),
        degen_uniforms=streams["degen_uniforms"].to(device))
    return float(res.threshold), int(res.n_rounds)


def check_pose_card_vs_cpu(torch, pipeline, corr, pose, K, dist, pose_cfg,
                           streams):
    """The pose stage again on the CPU from the card's correspondences and
    the same streams: rotation within POSE_ROT_DEG, translation direction
    within POSE_TANG_DEG, inlier masks equal on >= POSE_INLIER_AGREE of
    the slots, the Halign error code equal; for AutoTh also the adapted
    threshold within AUTOTH_TH_RTOL and the round count equal. Returns
    (record, failures)."""
    from matchinglib_poselib_torch.ops import geometry as geo
    from matchinglib_poselib_torch.ops import robust

    cpu = pipeline.estimate_pose(
        corr.pts1.cpu(), corr.pts2.cpu(), corr.mask.cpu(),
        corr.quality.cpu(), K.cpu(), K.cpu(), dist.cpu(), dist.cpu(),
        pose_cfg, **{k: v.cpu() for k, v in streams.items()})
    rec = {
        "rot_deg": _rot_deg(pose.R.cpu().numpy(), cpu.R.numpy()),
        "t_deg": _dir_deg(pose.t.cpu().numpy(), cpu.t.numpy()),
        "inliers": float((pose.inlier_mask.cpu()
                          == cpu.inlier_mask).float().mean()),
        "halign_error_code": [int(pose.halign_error_code),
                              int(cpu.halign_error_code)],
    }
    failures = []
    if rec["rot_deg"] >= POSE_ROT_DEG or rec["t_deg"] >= POSE_TANG_DEG:
        failures.append(f"card vs CPU pose: {rec['rot_deg']:.4f} deg, "
                        f"{rec['t_deg']:.4f} deg")
    if rec["inliers"] < POSE_INLIER_AGREE:
        failures.append(f"card vs CPU inlier slots {rec['inliers']:.4f}")
    if len(set(rec["halign_error_code"])) != 1:
        failures.append(f"card vs CPU Halign codes "
                        f"{rec['halign_error_code']}")
    if pose_cfg.auto_th:
        card_th = _autoth_on(robust, geo, pose_cfg, corr, K, dist, streams,
                             K.device)
        cpu_th = _autoth_on(robust, geo, pose_cfg, corr, K, dist, streams,
                            torch.device("cpu"))
        rec["autoth_threshold"] = [card_th[0], cpu_th[0]]
        rec["autoth_rounds"] = [card_th[1], cpu_th[1]]
        if (abs(card_th[0] - cpu_th[0]) > AUTOTH_TH_RTOL * abs(cpu_th[0])
                or card_th[1] != cpu_th[1]):
            failures.append(f"card vs CPU AutoTh threshold / rounds "
                            f"{card_th} vs {cpu_th}")
    return rec, failures


def check_no_host_sync(torch, name, fn):
    """Run `fn` on the card under ``set_sync_debug_mode("error")``: a host
    read inside raises. Returns a list with the failure, or empty."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    except RuntimeError as e:
        return [f"{name}: host sync on the card: {str(e).splitlines()[0]}"]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return []


def sync_free_checks(torch, corr, pose, K, dist):
    """``bundle_adjust`` (through ``refine_stereo_ba``, as the BA branch
    calls it) and the eigensolver's Newton loop on the card's data, each
    under ``check_no_host_sync``."""
    from matchinglib_poselib_torch import config as cfg
    from matchinglib_poselib_torch.ops import ba, eigensolver
    from matchinglib_poselib_torch.ops import geometry as geo

    x1 = geo.undistort_oulu(geo.img_to_cam(corr.pts1, K), dist)
    x2 = geo.undistort_oulu(geo.img_to_cam(corr.pts2, K), dist)
    inl = pose.inlier_mask & pose.valid3d
    eye = torch.eye(3, device=K.device)
    f_mean = 0.5 * (K[0, 0] + K[1, 1])
    return (
        check_no_host_sync(torch, "bundle_adjust", lambda: ba.refine_stereo_ba(
            pose.R, pose.t, x1, x2, pose.points3d, inl.float(), eye, eye,
            cfg.BAConfig(enabled=True), huber_delta=1.0 / f_mean))
        + check_no_host_sync(
            torch, "solve_eigensolver", lambda: eigensolver.solve_eigensolver(
                x1, x2, inl.float(), R0=pose.R)))


# phase 6, the stream: frames, the bad pair (1-based), frames rerun on the
# CPU, the checkpoint's frame, the pool size to pass, card vs CPU bars
STREAM_FRAMES = 10
STREAM_BAD_FRAME = 7
STREAM_CPU_FRAMES = 6
STREAM_CKPT_AFTER = 4
STREAM_MIN_POOL = 1000
STREAM_POOL_RTOL = 0.01
STREAM_CKPT_TOL = 1e-6
# the pool capacity of the rerun that fills it (the CPU tests' size)
STREAM_FULL_POOL = 1024
ACCEPTED = ("init", "refined", "robust", "reinit")


def stereo_ref_config(cfg):
    """``poselib-test --stereoRef`` at its default arguments, spelled out
    (the JAX package's ``apps/common.py``: ``add_pose_options``,
    ``add_stereo_refine_options``, ``pose_config``,
    ``stereo_refine_config``): USAC, Nister 5pt, th 0.8 px, the
    degeneracy check at 0.85, refineRT / refineRT_stereo "22" (8pt IRLS,
    pseudo-Huber), no BA, a pool of 30,000 with 4096-point refine caps."""
    pose = cfg.PoseConfig(
        robust=cfg.RobustConfig(
            estimator=cfg.PoseEstimator.USAC,
            solver=cfg.MinimalSolver.NISTER_5PT, threshold_px=0.8,
            check_degeneracy=True, degen_decision_ratio=0.85),
        refine=cfg.RefinementConfig(
            enabled=True, solver=cfg.MinimalSolver.EIGHT_PT,
            weights=cfg.RefineWeights.PSEUDO_HUBER),
        ba=cfg.BAConfig(enabled=False, fix_intrinsics=True))
    return cfg.StereoRefineConfig(
        max_pool_correspondences=30000, min_pts_distance=3.0,
        check_pool_pose_robust=3, min_start_agg_inl_rat=0.2,
        rel_inl_rat_th_last=0.35, rel_inl_rat_th_new=0.2,
        min_inlier_rat_skip=0.38, rel_min_inlier_rat_skip=0.7,
        max_skip_pairs=5, min_inlier_ratio_reinit=0.67,
        min_cont_stable_poses=3, abs_th_ranking_stable=0.075,
        min_norm_dist_stable=0.5, raise_skip_cnt=0, max_rat_3d_pts_far=0.4,
        max_dist_3d_pts_z=130.0, use_ransac_few_matches=False,
        kneip_instead_ba=False, kneip_instead_ba_pool=False,
        refine_pool=cfg.RefinementConfig(
            enabled=True, solver=cfg.MinimalSolver.EIGHT_PT,
            weights=cfg.RefineWeights.PSEUDO_HUBER, refine_max_points=4096,
            polish_max_points=4096),
        ba_pool=cfg.BAConfig(enabled=False, fix_intrinsics=True),
        verbose=0, pose=pose)


class SeededStreams:
    """``StereoRefine``'s ``streams``: (uniforms (max_batches, B, k),
    degen_uniforms (1, min(B, 64), 4)) per robust call from a CPU
    generator seeded with `seed`; `skip` calls are drawn and dropped first
    (a stream resumed after that many calls). ``calls`` counts them."""

    def __init__(self, torch, robust_cfg, seed, skip=0):
        from matchinglib_poselib_torch.ops import robust

        self.torch = torch
        self.gen = torch.Generator().manual_seed(seed)
        self.shapes = robust.sample_shapes(robust_cfg)
        self.calls = 0
        for _ in range(skip):
            self()

    def __call__(self):
        self.calls += 1
        return tuple(self.torch.rand(s, generator=self.gen)
                     for s in self.shapes)


def _stats(xs):
    return ({"mean": float(np.mean(xs)), "median": float(np.median(xs)),
             "min": float(np.min(xs))} if xs else None)


def _feed(sr, c):
    """One frame into StereoRefine as poselib-test feeds it."""
    return sr.add_new_correspondences(c[0], c[1], c[2], c[3], desc_dist=c[4])


def check_stream(results, per_frame, launches):
    """Phase 6's checks on the card's run: K1 and K2a 2 launches each per
    frame, frame 1 init, every good frame refined or robust, the bad frame
    skipped (pose unchanged) or robust, every accepted pose within the
    accuracy bars, the pool past STREAM_MIN_POOL. Returns failures."""
    frames = len(results)
    failures = [f"{k} launched {launches[k]} times over {frames} frames "
                f"(expected {n})" for k, n in (("fast_nms", 2 * frames),
                                               ("knn2", 2 * frames),
                                               ("knn2_l2", 0))
                if launches[k] != n]
    states = [r.state for r in results]
    if states[0] != "init":
        failures.append(f"frame 1 is {states[0]}, not init")
    for f, st in enumerate(states[1:], start=2):
        if f != STREAM_BAD_FRAME and st not in ("refined", "robust"):
            failures.append(f"good frame {f} is {st}")
    bad, before = results[STREAM_BAD_FRAME - 1], results[STREAM_BAD_FRAME - 2]
    if bad.state not in ("skipped", "robust"):
        failures.append(f"bad frame {STREAM_BAD_FRAME} is {bad.state}")
    if bad.state == "skipped" and not (np.array_equal(bad.R, before.R)
                                       and np.array_equal(bad.t, before.t)):
        failures.append("the skipped frame changed the pose")
    for f, rec in enumerate(per_frame, start=1):
        if rec["state"] in ACCEPTED and (rec["rot_err_deg"] >= MAX_ROT_DEG
                                         or rec["t_err_deg"] >= MAX_TANG_DEG):
            failures.append(f"frame {f} ({rec['state']}) off the planted "
                            f"pose: rot {rec['rot_err_deg']:.4f} t "
                            f"{rec['t_err_deg']:.4f} deg")
    if max(r.pool_size for r in results) <= STREAM_MIN_POOL:
        failures.append(f"pool never passed {STREAM_MIN_POOL}: "
                        f"{[r.pool_size for r in results]}")
    return failures


def _frame_card_vs_cpu(f, r, r_cpu):
    """(record, agrees) of frame f's card and CPU results: the same
    state, pools within STREAM_POOL_RTOL, R and t within POSE_ROT_DEG /
    POSE_TANG_DEG."""
    cmp = {"frame": f, "states": [r.state, r_cpu.state],
           "pool": [r.pool_size, r_cpu.pool_size],
           "rot_deg": _rot_deg(r.R, r_cpu.R),
           "t_deg": _dir_deg(r.t, r_cpu.t)}
    return cmp, (r.state == r_cpu.state
                 and abs(r.pool_size - r_cpu.pool_size)
                 <= STREAM_POOL_RTOL * max(r_cpu.pool_size, 1)
                 and cmp["rot_deg"] < POSE_ROT_DEG
                 and cmp["t_deg"] < POSE_TANG_DEG)


def stream_card_vs_cpu(new_sr, corrs, results):
    """Frames 1..STREAM_CPU_FRAMES again on the CPU from the card's
    correspondences with the same streams, held to
    ``_frame_card_vs_cpu``. Returns (per-frame record, failures)."""
    cpu_sr = new_sr("cpu")
    rec, failures = [], []
    for f in range(1, STREAM_CPU_FRAMES + 1):
        r_cpu = _feed(cpu_sr, tuple(x.cpu() for x in corrs[f - 1]))
        cmp, agrees = _frame_card_vs_cpu(f, results[f - 1], r_cpu)
        rec.append(cmp)
        if not agrees:
            failures.append(f"card vs CPU: {cmp}")
    return rec, failures


def stream_full_pool(new_sr, corrs, dev):
    """Every frame again at a pool of STREAM_FULL_POOL, on the card and on
    the CPU from the card's correspondences with the same streams, so
    that the pool fills: eviction of valid rows and the robust cadence's
    ``max_pool_size_reached`` branch run on the card. The pool must fill;
    every frame is held to ``_frame_card_vs_cpu``. Returns (record,
    failures)."""
    card = new_sr(dev, capacity=STREAM_FULL_POOL)
    cpu = new_sr("cpu", capacity=STREAM_FULL_POOL)
    rec = {"capacity": STREAM_FULL_POOL, "full_at_frame": None,
           "frames": []}
    failures = []
    for f, c in enumerate(corrs, start=1):
        cmp, agrees = _frame_card_vs_cpu(
            f, _feed(card, c), _feed(cpu, tuple(x.cpu() for x in c)))
        rec["frames"].append(cmp)
        if not agrees:
            failures.append(f"full pool, card vs CPU: {cmp}")
        if rec["full_at_frame"] is None and card.max_pool_size_reached:
            rec["full_at_frame"] = f
    if rec["full_at_frame"] is None:
        failures.append(f"the pool of {STREAM_FULL_POOL} never filled on "
                        f"the card: {rec}")
    return rec, failures


def stream_resume(checkpoint, new_sr, ckdir, calls_before, corrs, results,
                  sr):
    """The checkpoint written after frame STREAM_CKPT_AFTER, resumed on
    the card: the rest of the stream in the same states, R and t within
    STREAM_CKPT_TOL of the uninterrupted run (and whether bit-equal; if
    not, which checkpoint arrays differ after the last frame). Returns
    (record, failures)."""
    f0 = STREAM_CKPT_AFTER + 1
    res_sr = new_sr(sr.device, skip=calls_before[f0])
    checkpoint.load_stereo_refine(res_sr, f"{ckdir}/before_{f0}.npz")
    max_diff, states = 0.0, []
    for f in range(f0, len(results) + 1):
        r2, r = _feed(res_sr, corrs[f - 1]), results[f - 1]
        states.append(r2.state)
        max_diff = max(max_diff, float(np.abs(r2.R - r.R).max()),
                       float(np.abs(r2.t - r.t).max()))
    rec = {"after_frame": STREAM_CKPT_AFTER, "states": states,
           "max_abs_diff_Rt": max_diff, "bit_equal": max_diff == 0.0}
    if not rec["bit_equal"]:
        checkpoint.save_stereo_refine(sr, f"{ckdir}/main_end.npz")
        checkpoint.save_stereo_refine(res_sr, f"{ckdir}/res_end.npz")
        with np.load(f"{ckdir}/main_end.npz") as a, \
                np.load(f"{ckdir}/res_end.npz") as b:
            rec["differing_arrays"] = [k for k in a.files
                                       if not np.array_equal(a[k], b[k])]
    want = [r.state for r in results[f0 - 1:]]
    failures = ([] if states == want and max_diff <= STREAM_CKPT_TOL
                else [f"checkpoint resume on the card: {rec} vs {want}"])
    return rec, failures


def profile_stream_frames(torch, checkpoint, new_sr, ckdir, calls_before,
                          corrs, results, dev):
    """The first refined and the first robust frame after frame 1, each
    resumed from the checkpoint before it and run under the profiler:
    device-busy ms, device ops, wall ms. Returns (record, failures)."""
    rec, failures = {}, []
    states = [r.state for r in results]
    for want in ("refined", "robust"):
        f = next((i for i, st in enumerate(states, start=1)
                  if st == want and i > 1), None)
        if f is None:
            rec[want] = None
            continue
        p_sr = new_sr(dev, skip=calls_before[f])
        checkpoint.load_stereo_refine(p_sr, f"{ckdir}/before_{f}.npz")
        out = []
        busy, ops, wall = _profile_step(
            torch, lambda: out.append(_feed(p_sr, corrs[f - 1])))
        rec[want] = {"frame": f, "device_busy_ms": busy, "device_ops": ops,
                     "wall_ms": wall, "state": out[0].state}
        if out[0].state != want:
            failures.append(f"profiled frame {f}: {out[0].state}, the "
                            f"run's {want}")
    return rec, failures


def stream_phase(torch, cfg, det, desc, match, dev, seed):
    """Phase 6: ``StereoRefine`` at the ``--stereoRef`` defaults on the
    card over a seeded sequence (``render_sequence``), fed by the port's
    front end at the flagship config, with a checkpoint written before
    every frame; then ``check_stream``, ``stream_card_vs_cpu``,
    ``stream_full_pool``, ``stream_resume`` and
    ``profile_stream_frames``. Returns (step
    record, failures)."""
    import tempfile

    from matchinglib_poselib_torch.models import checkpoint, pipeline
    from matchinglib_poselib_torch.models.stereo_refine import StereoRefine
    from matchinglib_poselib_torch.ops import kernels
    from matchinglib_poselib_torch.utils.profiling import HostSyncs

    t_phase = time.perf_counter()
    pairs, K, R_true, t_true = _sequence(seed)
    render_s = time.perf_counter() - t_phase
    sr_cfg = stereo_ref_config(cfg)
    s_seed = seed + 100
    dist = np.zeros(5, np.float32)
    pairs_dev = [tuple(torch.from_numpy(x).to(dev) for x in p) for p in pairs]
    pipe = pipeline.StereoPipeline(det, desc, match, sr_cfg.pose, device=dev)

    def new_sr(device, skip=0, capacity=sr_cfg.max_pool_correspondences):
        return StereoRefine(
            K, K, dist, dist, device=device,
            cfg=dataclasses.replace(sr_cfg,
                                    max_pool_correspondences=capacity),
            streams=SeededStreams(torch, sr_cfg.pose.robust, s_seed, skip))

    sr = new_sr(dev)
    tmp = tempfile.TemporaryDirectory()
    ckdir = tmp.name
    calls_before, corrs, results, per_frame = {}, [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    for f, (i1, i2) in enumerate(pairs_dev, start=1):
        calls_before[f] = sr.streams.calls
        checkpoint.save_stereo_refine(sr, f"{ckdir}/before_{f}.npz",
                                      seed=s_seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        corr = pipe.correspondences(i1, i2)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        syncs0 = HostSyncs.count
        c = (corr.pts1, corr.pts2, corr.mask, corr.quality, corr.distance)
        fr = _feed(sr, c)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        corrs.append(c)
        results.append(fr)
        per_frame.append({
            "state": fr.state, "corr_ms": (t1 - t0) * 1e3,
            "stereoRefine_ms": (t2 - t1) * 1e3,
            "host_syncs": HostSyncs.count - syncs0,
            "n_corr": int(corr.n), "pool_size": fr.pool_size,
            "inlier_ratio": fr.inlier_ratio,
            "rot_err_deg": _rot_deg(R_true, fr.R),
            "t_err_deg": _dir_deg(t_true, fr.t)})
    main_s = time.perf_counter() - t_phase - render_s
    launches = kernels.launch_counts()
    peak_mib = torch.cuda.max_memory_allocated(dev) / 2**20
    failures = check_stream(results, per_frame, launches)

    times = {"render_s": render_s, "main_s": main_s}
    t0 = time.perf_counter()
    cpu_vs, fails = stream_card_vs_cpu(new_sr, corrs, results)
    failures += fails
    times["cpu_rerun_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    full_pool, fails = stream_full_pool(new_sr, corrs, dev)
    failures += fails
    times["full_pool_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ckpt, fails = stream_resume(checkpoint, new_sr, ckdir, calls_before,
                                corrs, results, sr)
    failures += fails
    times["checkpoint_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    profiled, fails = profile_stream_frames(
        torch, checkpoint, new_sr, ckdir, calls_before, corrs, results, dev)
    failures += fails
    times["profiled_s"] = time.perf_counter() - t0
    tmp.cleanup()

    acc = [p for p in per_frame if p["state"] in ACCEPTED]
    by_state = {}
    for p in per_frame:
        by_state.setdefault(p["state"], []).append(p["stereoRefine_ms"])
    record = {
        "frames": STREAM_FRAMES, "states": [r.state for r in results],
        "launches": launches, "per_frame": per_frame,
        "accepted_ms": {
            "correspondences": _stats([p["corr_ms"] for p in acc]),
            "stereoRefine": _stats([p["stereoRefine_ms"] for p in acc]),
            "total": _stats([p["corr_ms"] + p["stereoRefine_ms"]
                             for p in acc])},
        "stereoRefine_ms_by_state": {k: _stats(v)
                                     for k, v in by_state.items()},
        "host_syncs_per_frame": _stats([p["host_syncs"] for p in per_frame]),
        "profiled": profiled, "pool_final": results[-1].pool_size,
        "peak_mib": peak_mib, "card_vs_cpu": cpu_vs, "full_pool": full_pool,
        "checkpoint": ckpt,
        **times, "phase_s": time.perf_counter() - t_phase,
    }
    return record, failures


# phase 7, the batch: the first BATCH_PAIRS frames of the sequence (the
# bad pair among them) through run_batch; timed batches; the batch against
# run of each pair on the card (deg); the pose stage's device ops against
# the costliest pair's alone. Host syncs: each run of each loop of the
# batch (the robust batches, LO, each LM polish, the polish rounds) reads
# once per iteration until its slowest pair has left, so the batch reads
# at most the sum over those runs of the most iterations any pair takes
# there alone (``loop_iterations``), plus BATCH_SYNC_SLACK for an f32 tie
# that the card's batched products break otherwise than a batch of one;
# a stage that looped over the pairs would read once per pair instead
BATCH_PAIRS = 8
BATCH_TIMED_RUNS = 5
BATCH_ROT_DEG, BATCH_TANG_DEG = 0.01, 0.05
BATCH_OPS_RATIO = 1.5
BATCH_SYNC_SLACK = 2
# phase 4's flagship step: device ops of one profiled step before the
# pair axis (PERF.md §5), which the single-pair path must not exceed by
# more than FLAGSHIP_OPS_SLACK, and host syncs of one step with the
# closed-form LM Jacobian (PERF.md §6), which it must not exceed by more
# than FLAGSHIP_SYNCS_SLACK (the LM latch compares costs at f32 noise)
FLAGSHIP_DEVICE_OPS = 31143
FLAGSHIP_OPS_SLACK = 1.03
FLAGSHIP_HOST_SYNCS = 24
FLAGSHIP_SYNCS_SLACK = 2


def batch_streams(torch, robust, pose_cfg, seed, pairs):
    """Seeded explicit streams of a batch on the CPU, pair after pair:
    (uniforms (P, max_batches, B, k), degen_uniforms (P, 1, min(B, 64),
    4))."""
    g = torch.Generator().manual_seed(seed)
    e_shape, d_shape = robust.sample_shapes(pose_cfg.robust)
    drawn = [(torch.rand(e_shape, generator=g),
              torch.rand(d_shape, generator=g)) for _ in range(pairs)]
    return (torch.stack([u for u, _ in drawn]),
            torch.stack([d for _, d in drawn]))


def batch_vs_run(torch, corr, pose, singles):
    """Per pair, the batch against ``run`` of that pair alone with the
    same streams: shares of keypoint slots (mask and xy within 1e-4) and
    match slots (mask; partner within 1e-4 where kept), inlier masks
    equal, rotation and translation direction differences (deg). Returns
    (rows, failures)."""
    rows, failures = [], []
    for i, (c, p) in enumerate(singles):
        kp = min(float(((getattr(corr, s).mask[i] == getattr(c, s).mask)
                        & ((getattr(corr, s).xy[i] - getattr(c, s).xy)
                           .abs().amax(-1) <= 1e-4)).float().mean())
                 for s in ("kps1", "kps2"))
        same = (corr.pts2[i] - c.pts2).abs().amax(-1) <= 1e-4
        matches = float(((corr.mask[i] == c.mask)
                         & (same | ~c.mask)).float().mean())
        row = {"keypoints": kp, "matches": matches,
               "inliers_equal": bool(torch.equal(pose.inlier_mask[i],
                                                 p.inlier_mask)),
               "rot_deg": _rot_deg(pose.R[i].cpu().numpy(),
                                   p.R.cpu().numpy()),
               "t_deg": _dir_deg(pose.t[i].cpu().numpy(), p.t.cpu().numpy())}
        rows.append(row)
        if (kp < 1.0 or matches < 1.0 or not row["inliers_equal"]
                or row["rot_deg"] >= BATCH_ROT_DEG
                or row["t_deg"] >= BATCH_TANG_DEG):
            failures.append(f"pair {i + 1}: batch vs run {row}")
    return rows, failures


def batch_card_vs_cpu(torch, pipeline, corr, pose, K, dist, pose_cfg,
                      streams):
    """The batch's pose stage again on the CPU from the card's
    correspondences and the same streams, held per pair to phase 4d's bars
    (POSE_ROT_DEG, POSE_TANG_DEG, POSE_INLIER_AGREE). Returns (rows,
    failures)."""
    cpu = pipeline.estimate_pose(
        corr.pts1.cpu(), corr.pts2.cpu(), corr.mask.cpu(),
        corr.quality.cpu(), K.cpu(), K.cpu(), dist.cpu(), dist.cpu(),
        pose_cfg, uniforms=streams[0].cpu(), degen_uniforms=streams[1].cpu())
    rows, failures = [], []
    for i in range(corr.mask.shape[0]):
        row = {"rot_deg": _rot_deg(pose.R[i].cpu().numpy(), cpu.R[i].numpy()),
               "t_deg": _dir_deg(pose.t[i].cpu().numpy(), cpu.t[i].numpy()),
               "inliers": float((pose.inlier_mask[i].cpu()
                                 == cpu.inlier_mask[i]).float().mean())}
        rows.append(row)
        if (row["rot_deg"] >= POSE_ROT_DEG or row["t_deg"] >= POSE_TANG_DEG
                or row["inliers"] < POSE_INLIER_AGREE):
            failures.append(f"pair {i + 1}: card vs CPU pose stage {row}")
    return rows, failures


def batch_phase(torch, det, desc, match, pose_cfg, dev, seed):
    """Phase 7: ``StereoPipeline.run_batch`` at the flagship config on the
    first BATCH_PAIRS frames of the sequence with seeded explicit streams
    (``batch_streams``): counters from 0, one batch, counters read back (K1
    once, K2a twice per pair); K1 against its plain version at every pixel
    of the batch's (2P, H, W) stack; the good pairs within the accuracy
    bars; each pair alone through ``run`` (``batch_vs_run``, host syncs per
    loop run, ms);
    the pose stage on the CPU (``batch_card_vs_cpu``); BATCH_TIMED_RUNS
    timed batches beside the pairs run one by one; one profiled batch,
    its pose stage and the costliest pair's pose stage alone (device
    ops). Returns (step record, failures)."""
    from matchinglib_poselib_torch.models import pipeline
    from matchinglib_poselib_torch.ops import kernels, robust
    from matchinglib_poselib_torch.ops.kernels import fast_nms
    from matchinglib_poselib_torch.utils.profiling import (
        HostSyncs, loop_iterations,
    )

    t_phase = time.perf_counter()
    pairs, K, R_true, t_true = _sequence(seed)
    pairs = pairs[:BATCH_PAIRS]
    P = len(pairs)
    imgs1 = torch.from_numpy(np.stack([a for a, _ in pairs])).to(dev)
    imgs2 = torch.from_numpy(np.stack([b for _, b in pairs])).to(dev)
    Kt = torch.from_numpy(K).to(dev)
    dist = torch.zeros(5, device=dev)
    U, D = batch_streams(torch, robust, pose_cfg, seed + 30, P)
    pipe = pipeline.StereoPipeline(det, desc, match, pose_cfg, device=dev)

    def batch():
        return pipe.run_batch(imgs1, imgs2, Kt, Kt, dist, dist, uniforms=U,
                              degen_uniforms=D)

    def run(i):
        return pipe.run(imgs1[i], imgs2[i], Kt, Kt, dist, dist,
                        uniforms=U[i], degen_uniforms=D[i])

    # the main path: counts set to 0 just before, read just after
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with HostSyncs.traced() as log:
        corr, pose = batch()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    host_syncs = len(log)
    expected = {"fast_nms": 1, "knn2": 2 * P, "knn2_l2": 0}
    failures = [f"{k} launched {launches[k]} times in the batch (expected "
                f"{v})" for k, v in expected.items() if launches[k] != v]
    # K1 at every pixel of the stack the counted launch scored
    k1_err, k1_ties = check_fast_nms(
        torch, fast_nms, torch.cat([imgs1, imgs2]),
        det.fast_threshold / 255.0, det.nms_radius)
    if k1_ties:
        failures.append(f"fast_nms: {k1_ties} tie mismatches on the "
                        "batch's stack, expected 0")
    if (pose.R.shape != (P, 3, 3)
            or corr.mask.shape != (P, det.max_keypoints)):
        failures.append("unexpected output shapes")
    if not bool(torch.isfinite(pose.R).all() and torch.isfinite(pose.t).all()
                and torch.isfinite(corr.pts2).all()):
        failures.append("non-finite pose or correspondences")
    per_pair = []
    models_per_batch = pose_cfg.robust.batch_hypotheses * 10
    for i in range(P):
        row = {"n_corr": int(corr.n[i]), "n_inliers": int(pose.n_inliers[i]),
               "n_batches": int(pose.n_models_generated[i])
               // models_per_batch,
               "rot_err_deg": _rot_deg(R_true, pose.R[i].cpu().numpy()),
               "t_err_deg": _dir_deg(t_true, pose.t[i].cpu().numpy())}
        per_pair.append(row)
        if i + 1 != STREAM_BAD_FRAME and (
                row["rot_err_deg"] >= MAX_ROT_DEG
                or row["t_err_deg"] >= MAX_TANG_DEG
                or row["n_corr"] < MIN_CORR
                or row["n_inliers"] < MIN_INLIERS):
            failures.append(f"pair {i + 1} off the accuracy bars: {row}")

    # each pair alone through run, with its own streams
    singles, loops_alone = [], []
    for i in range(P):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with HostSyncs.traced() as log_i:
            singles.append(run(i))
        torch.cuda.synchronize()
        per_pair[i]["run_ms"] = (time.perf_counter() - t0) * 1e3
        per_pair[i]["run_host_syncs"] = len(log_i)
        loops_alone.append(loop_iterations(log_i))
    vs_run, fails = batch_vs_run(torch, corr, pose, singles)
    failures += fails
    alone = [p["run_host_syncs"] for p in per_pair]
    # per run of each loop: the batch's reads, the most of any pair alone
    loops_batch = loop_iterations(log)
    loop_runs = {f"{site}#{k}": [loops_batch.get((site, k), 0),
                                 max(a.get((site, k), 0) for a in loops_alone)]
                 for site, k in sorted({*loops_batch,
                                        *(x for a in loops_alone for x in a)})}
    sync_bound = sum(m for _, m in loop_runs.values()) + BATCH_SYNC_SLACK
    if host_syncs > sync_bound:
        failures.append(f"{host_syncs} host syncs in the batch, more than "
                        f"{sync_bound}: loop runs [batch, slowest pair "
                        f"alone] {loop_runs}")
    t0 = time.perf_counter()
    vs_cpu, fails = batch_card_vs_cpu(torch, pipeline, corr, pose, Kt, dist,
                                      pose_cfg, (U, D))
    failures += fails
    cpu_s = time.perf_counter() - t0

    # timed batches, then the same pairs one by one in the same run
    pipe.timer.reset()
    torch.cuda.reset_peak_memory_stats(dev)
    batch_ms = []
    for _ in range(BATCH_TIMED_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch()
        torch.cuda.synchronize()
        batch_ms.append((time.perf_counter() - t0) * 1e3)
    stages = {k: v / BATCH_TIMED_RUNS for k, v in pipe.timer.times_ms.items()}
    peak_mib = torch.cuda.max_memory_allocated(dev) / 2**20
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(P):
        run(i)
    torch.cuda.synchronize()
    runs_ms = (time.perf_counter() - t0) * 1e3

    # device ops: one batch, its pose stage, each pair's pose stage alone
    def pose_stage(sel):
        return lambda: pipeline.estimate_pose(
            corr.pts1[sel], corr.pts2[sel], corr.mask[sel], corr.quality[sel],
            Kt, Kt, dist, dist, pose_cfg, uniforms=U[sel].to(dev),
            degen_uniforms=D[sel].to(dev))

    # the costliest pair alone: the most robust batches, then the longest
    costliest = max(range(P), key=lambda i: (per_pair[i]["n_batches"],
                                             per_pair[i]["run_ms"]))
    t0 = time.perf_counter()
    busy_ms, device_ops, prof_wall_ms = _profile_step(torch, batch)
    pose_busy, pose_ops, _ = _profile_step(torch, pose_stage(slice(None)))
    alone_busy, alone_ops, _ = _profile_step(torch, pose_stage(costliest))
    profiled_s = time.perf_counter() - t0
    if pose_ops > BATCH_OPS_RATIO * alone_ops:
        failures.append(f"the batch's pose stage: {pose_ops} device ops, "
                        f"pair {costliest + 1} alone {alone_ops}")
    mean_ms = float(np.mean(batch_ms))
    record = {
        "pairs": P, "launches": launches, "host_syncs_per_batch": host_syncs,
        "host_syncs_bound": sync_bound, "host_syncs_loop_runs": loop_runs,
        "host_syncs_pairs_alone": alone, "per_pair": per_pair,
        "k1_batch_stack": {"shape": [2 * P, *imgs1.shape[1:]],
                           "max_abs_err": k1_err, "tie_mismatches": k1_ties},
        "batch_vs_run": vs_run, "card_vs_cpu_pose": vs_cpu,
        "warm_s": warm_s, "runs": BATCH_TIMED_RUNS, "ms_mean": mean_ms,
        "ms_median": float(np.median(batch_ms)),
        "ms_min": float(np.min(batch_ms)), "pairs_per_s": P / mean_ms * 1e3,
        "stages_ms": stages, "pairs_one_by_one_ms": runs_ms,
        "pairs_one_by_one_per_s": P / runs_ms * 1e3, "peak_mem_mib": peak_mib,
        "profiled_run": {"wall_ms": prof_wall_ms, "device_busy_ms": busy_ms,
                         "device_ops": device_ops},
        "pose_stage_profiled": {
            "device_busy_ms": pose_busy, "device_ops": pose_ops,
            "costliest_pair": costliest + 1,
            "costliest_pair_alone": {"device_busy_ms": alone_busy,
                                     "device_ops": alone_ops}},
        "cpu_check_s": cpu_s, "profiled_s": profiled_s,
        "phase_s": time.perf_counter() - t_phase,
    }
    return record, failures


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
            if "registers" in line or "smem" in line or "spill" in line:
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

    # 2. K1: fused FAST+NMS vs the zero-padded plain version at every
    # pixel, at the main path's shapes and at ragged shapes and radii
    one = i1[None].contiguous()
    two = torch.stack([i1, i2]).contiguous()
    (k1_err, k1_ties), (k1_pad_err, k1_pad_ties) = check_fast_nms_padded(
        torch, fast_nms, np.random.default_rng(args.seed + 3), (one, two),
        thr, dev)
    for bad in (dict(radius=fast_nms.MAX_RADIUS + 1),
                dict(threshold=-thr)):
        kw = dict(threshold=thr, radius=det.nms_radius) | bad
        try:
            fast_nms.fast_nms_score(one, **kw)
        except ValueError:
            pass
        else:
            raise AssertionError(f"fast_nms: {bad} on the card did not raise")
    k1 = functools.partial(fast_nms.fast_nms_score, one, thr, det.nms_radius)
    k1_plain = functools.partial(fast_nms.fast_nms_score_plain, one, thr,
                                 det.nms_radius)
    k1_ms, k1_plain_ms = _cuda_ms(torch, k1), _cuda_ms(torch, k1_plain)
    k1_dev_ms, k1_per_call = _device_profile(torch, k1)
    k1_plain_dev_ms = _device_ms(torch, k1_plain)
    if k1_per_call != 1:
        raise AssertionError(f"fast_nms: {k1_per_call} kernels per call, "
                             "not 1")

    # 3. K2a: fused 2-NN vs plain at 2048 x 2048 on the scene's descriptors
    corr = pipeline.get_correspondences(i1, i2, det, desc, match)
    d1, _ = features.compute_descriptors(i1, corr.kps1, desc,
                                         features.detector_bands(det))
    d2, _ = features.compute_descriptors(i2, corr.kps2, desc,
                                         features.detector_bands(det))
    cases = knn2_inputs(torch, rng, d1, d2, corr.kps1.xy, corr.kps2.xy, dev)
    k2_err = check_knn2(torch, knn2, cases)
    check_knn2_ragged(torch, knn2, knn2_ragged_cases(
        torch, np.random.default_rng(args.seed + 1), dev))
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
    k2b_err = check_knn2_l2_ragged(torch, knn2, knn2_l2_ragged_cases(
        torch, np.random.default_rng(args.seed + 2), dev))
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
        k2b_bytes = (s1 + s2) * depth * 4 + s2 + s1 * 12
        k2b_ops_s = ((2 * s1 * s2 * depth + 2 * (s1 + s2) * depth
                      + 4 * s1 * s2) / FP32_FLOP_S)
        rec["bound_ms"], rec["bound_by"] = _bound(k2b_bytes, k2b_ops_s)
        # the gate's fp32 ops per pair, on the same pipe
        rec["bound_ms_guided"] = _bound(
            k2b_bytes, k2b_ops_s + s1 * s2 * KNN2_L2_GATE_FP32_OPS
            / (FP32_PER_CLK_SM * n_sm * SM_CLOCK_HZ))[0]
        for m in (0, 1):
            fk = functools.partial(knn2.knn2_l2, *fcases[m], xy_mode=m)
            fp = functools.partial(knn2.knn2_l2_plain, *fcases[m], xy_mode=m)
            rec[m] = {"ms": _cuda_ms(torch, fk),
                      "plain_ms": _cuda_ms(torch, fp)}
            rec[m]["device_ms"], rec[m]["kernels_per_call"] = (
                _device_profile(torch, fk))
            rec[m]["plain_device_ms"] = _device_ms(torch, fp)
            if rec[m]["kernels_per_call"] != 1:
                raise AssertionError(
                    f"knn2_l2 {name} xy_mode={m}: "
                    f"{rec[m]['kernels_per_call']} kernels per call, not 1")
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
    ops = rec["profiled_run"]["device_ops"]
    if ops is None or ops > FLAGSHIP_OPS_SLACK * FLAGSHIP_DEVICE_OPS:
        failures.append(f"FAST/ORB: {ops} device ops per step, "
                        f"{FLAGSHIP_DEVICE_OPS} before the pair axis")
    if rec["host_syncs_per_pair"] > FLAGSHIP_HOST_SYNCS + FLAGSHIP_SYNCS_SLACK:
        failures.append(f"FAST/ORB: {rec['host_syncs_per_pair']} host syncs "
                        f"per step, {FLAGSHIP_HOST_SYNCS} measured before")
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
    # 4d. the pose menu at the flagship config, each branch with explicit
    # streams, then card vs CPU on the pose stage
    from matchinglib_poselib_torch.ops import robust

    for b_i, (b_name, change, bars) in enumerate(pose_menu(cfg)):
        t_phase = time.perf_counter()
        b_cfg = dataclasses.replace(pose_cfg, **change)
        streams = pose_streams(torch, robust, b_cfg, args.seed + 10 + b_i)
        pipe = pipeline.StereoPipeline(det, desc, match, b_cfg)
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        (c, p), rec, fails = drive_path(
            torch, kernels, pipe, i1, i2, Kt, dist, gen, (R_true, t_true),
            {"fast_nms": 2, "knn2": 2}, POSE_TIMED_RUNS, streams=streams,
            bars=bars)
        failures.extend(f"{b_name}: {f}" for f in fails)
        rec["halign_error_code"] = int(p.halign_error_code)
        rec["pose_ms"] = rec["stages_ms"]["robEstimationAndRef"]
        t0 = time.perf_counter()
        rec["card_vs_cpu_pose"], fails = check_pose_card_vs_cpu(
            torch, pipeline, c, p, Kt, dist, b_cfg, streams)
        rec["cpu_check_s"] = time.perf_counter() - t0
        failures.extend(f"{b_name}: {f}" for f in fails)
        if b_name == "BA":
            t0 = time.perf_counter()
            failures.extend(sync_free_checks(torch, c, p, Kt, dist))
            rec["sync_checks_s"] = time.perf_counter() - t0
        # wall seconds of this branch's phase, checks included
        rec["phase_s"] = time.perf_counter() - t_phase
        steps.append((f"FAST t=12 / 2048 kp / ORB / GMBSOF / 96x12 5pt USAC"
                      f" / pose {b_name}", rec))
    # 6. the stream: StereoRefine on the card, fed by the front end
    stream_rec, fails = stream_phase(torch, cfg, det, desc, match, dev,
                                     args.seed)
    failures.extend(f"stream: {f}" for f in fails)
    steps.append(("stream: poselib-test --stereoRef defaults (pool 30000) /"
                  " FAST t=12 / 2048 kp / ORB / GMBSOF", stream_rec))
    # 7. the batch: run_batch on the sequence's first 8 pairs
    batch_rec, fails = batch_phase(torch, det, desc, match, pose_cfg, dev,
                                   args.seed)
    failures.extend(f"batch: {f}" for f in fails)
    steps.append((f"batch of {BATCH_PAIRS} (render_sequence frames 1-"
                  f"{BATCH_PAIRS}): FAST t=12 / 2048 kp / ORB / GMBSOF / "
                  "96x12 5pt USAC", batch_rec))
    for c_name, rec in steps:
        agree = rec.get("cpu_agree")
        if agree and min(agree.values()) < 0.99:
            failures.append(f"{c_name}: card vs CPU slots {agree}")
    if k1_ties or k1_pad_ties:
        failures.append(f"fast_nms: {k1_ties} tie mismatches at the main "
                        f"shapes, {k1_pad_ties} in all, expected 0")

    # bounds from this run's shapes. K1: the busiest of the bytes, the fp32
    # pipe and the compare / integer pipe, which run side by side
    n_px, sm_clk_s = one.numel(), n_sm * SM_CLOCK_HZ
    k1_pipes = {
        "fp32": n_px * K1_FP32_OPS / (FP32_PER_CLK_SM * sm_clk_s),
        "compare/int": n_px * (K1_ALU_OPS + k1_window_ops(det.nms_radius))
        / (INT32_PER_CLK_SM * sm_clk_s),
    }
    k1_pipe = max(k1_pipes, key=k1_pipes.get)
    k1_bound = _bound(2 * n_px * 4, k1_pipes[k1_pipe])
    # K2a: the least of two routes to the same distances, at this run's
    # shapes: popcount of the XOR of 8 words per pair, or the tensor-core
    # product (2 n1 n2 256 ops) with a 32-bit epilogue per pair. The
    # tensor cores, the integer pipe and the fp32 pipe run side by side,
    # so the busiest of them bounds the route.
    n1, n2 = cases[0][0].shape[0], cases[0][1].shape[0]
    pairs = n1 * n2
    k2_bytes = (n1 + n2) * 32 + n2 + n1 * 12
    k2_popc = _bound(k2_bytes, pairs * 8 / (POPC_PER_CLK_SM * sm_clk_s))
    k2_tc, k2_tc_guided = (
        _bound(k2_bytes, pairs / sm_clk_s * max(
            2 * 256 / BMMA_OPS_PER_CLK_SM, n_int / INT32_PER_CLK_SM,
            n_fp / FP32_PER_CLK_SM))
        for n_int, n_fp in zip(KNN2_INT_OPS, KNN2_FP32_OPS))
    k2_bound = min(k2_popc, k2_tc)
    kernels_line = {"kernels": [
        {"name": "fast_nms", "route": "cuda",
         "source": "matchinglib_poselib_torch/csrc/fast_nms.cu",
         "replaces": "matchinglib_poselib_tpu/ops/pallas/fast.py:113",
         "launches": launches["fast_nms"],
         "max_abs_err": max(k1_err,
                            batch_rec["k1_batch_stack"]["max_abs_err"]),
         "launches_stream": stream_rec["launches"]["fast_nms"],
         "launches_batch": batch_rec["launches"]["fast_nms"],
         "ms": k1_ms, "plain_ms": k1_plain_ms,
         "bound_ms": k1_bound[0], "bound_by": k1_bound[1],
         "bound_pipe": k1_pipe if k1_bound[1] == "operations" else "memory",
         "bound_pipes_ms": {k: v * 1e3 for k, v in k1_pipes.items()},
         "library_ms": None, "tie_mismatches": k1_ties,
         "all_cases_max_abs_err": k1_pad_err,
         "all_cases_tie_mismatches": k1_pad_ties,
         "kernels_per_call": k1_per_call,
         "device_ms": k1_dev_ms, "plain_device_ms": k1_plain_dev_ms},
        {"name": "knn2", "route": "cuda",
         "source": "matchinglib_poselib_torch/csrc/knn2.cu",
         "replaces": "matchinglib_poselib_tpu/ops/pallas/knn.py:131",
         "launches": launches["knn2"], "max_abs_err": k2_err,
         "launches_stream": stream_rec["launches"]["knn2"],
         "launches_batch": batch_rec["launches"]["knn2"],
         "ms": k2_ms[0], "plain_ms": k2_plain_ms[0],
         "bound_ms": k2_bound[0], "bound_by": k2_bound[1],
         "bound_route": "tensor cores" if k2_bound is k2_tc else "popc",
         "bound_popc_ms": k2_popc[0],
         "bound_ms_guided": min(k2_popc, k2_tc_guided)[0],
         "library_ms": None,
         "device_ms": k2_dev_ms[0], "plain_device_ms": k2_plain_dev_ms[0],
         "ms_guided": k2_ms[1], "plain_ms_guided": k2_plain_ms[1],
         "device_ms_guided": k2_dev_ms[1],
         "plain_device_ms_guided": k2_plain_dev_ms[1]},
        {"name": "knn2_l2", "route": "cuda",
         "source": "matchinglib_poselib_torch/csrc/knn2_l2.cu",
         "replaces": "matchinglib_poselib_tpu/ops/pallas/knn.py:51",
         "launches": sift_launches["knn2_l2"], "max_abs_err": k2b_err,
         "launches_batch": batch_rec["launches"]["knn2_l2"],
         "ms": k2b["sift"][0]["ms"], "plain_ms": k2b["sift"][0]["plain_ms"],
         "device_ms": k2b["sift"][0]["device_ms"],
         "plain_device_ms": k2b["sift"][0]["plain_device_ms"],
         "kernels_per_call": k2b["sift"][0]["kernels_per_call"],
         "bound_ms": k2b["sift"]["bound_ms"],
         "bound_by": k2b["sift"]["bound_by"], "library_ms": None,
         "ms_guided": k2b["sift"][1]["ms"],
         "plain_ms_guided": k2b["sift"][1]["plain_ms"],
         "device_ms_guided": k2b["sift"][1]["device_ms"],
         "plain_device_ms_guided": k2b["sift"][1]["plain_device_ms"],
         "bound_ms_guided": k2b["sift"]["bound_ms_guided"],
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
