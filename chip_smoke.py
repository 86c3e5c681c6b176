"""Drive the PyTorch port's main paths on one CUDA card and check them.

    python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero):
  1. build the CUDA kernels from ``matchinglib_poselib_torch/csrc`` (one
     nvcc per source, in parallel);
  2. fused FAST+NMS kernel vs its plain version at every pixel, border
     included, against the plain version of the input zero-padded by
     3 + r: on the scene's images at (1, 512, 1392) and (2, 512, 1392) and
     at the ragged shapes and radii of ``FAST_NMS_PADDED``; equal up to f32
     ties inside an NMS window (0 expected); radius 6 must raise on the
     card; a negative threshold bit-exact at (1, 512, 1392); one kernel
     per call;
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
     Halign, stereo BA (20 iterations), the Kneip polish, LMEDS and the
     Stewenius solver, each with
     explicit seeded sample streams (``pose_streams``): warm run, timed
     runs, K1 and K2a twice each, accuracy bars (Halign: the JAX
     package's 3 / 10 deg, whichever branch decided), then the pose stage
     again on the CPU from the card's correspondences and the same
     streams (``check_pose_card_vs_cpu``); ``bundle_adjust`` and the
     eigensolver's Newton loop on the card under
     ``torch.cuda.set_sync_debug_mode("error")`` (``check_no_host_sync``);
  4e. the matching menu (``match_menu``, ``match_phase``): the flagship
     config with sub-pixel refinement and VFC, and the FLANN matcher with
     the SOF filter, each with seeded explicit streams: warm run, timed
     runs, K1 2 and K2a 2 / 1 launches, accuracy bars, the CPU path's
     slots agree with the card's; each filter again on the card and on
     the CPU from the card's correspondences before the filters
     (``filters_card_vs_cpu``): subpix shifts within 1e-3 px, VFC and
     SOF-filter masks on >= 99% of the slots;
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
     beside the 8 pairs run one by one;
  7b. the batch with options (``batch_options_phase``): ``run_batch`` on
     the sequence's first 2 pairs with sub-pixel refinement, VFC, LMEDS
     and the Stewenius solver together, seeded explicit streams: K1 once,
     K2a twice per pair, both pairs within the accuracy bars, each equal
     to ``run`` of that pair on the card (slots 100%, inlier masks equal,
     0.01 / 0.05 deg).
  7c. the batch with each pose branch (``branch_batch_phase``):
     ``run_batch`` on the sequence's first 4 pairs with AutoTh, Halign,
     BA and Kneip, each at phase 4d's PoseConfig with seeded explicit
     streams (``branch_streams``): K1 once, K2a twice per pair, every pair
     within the branch's accuracy bars and equal to its own ``run`` on the
     card (slots 100%, inlier masks equal, 0.01 / 0.05 deg); per branch
     ms per batch (mean and median of 3 after the warm one), the 4 pairs'
     ``run`` ms one by one, host syncs per batch, device ops and busy ms
     of one profiled batch, printed with the card's name and power limit
     (``batch_branch`` lines), and the phase's wall seconds.

  8. the CLIs (``apps_phase``), in-process on the card: frames 1-3 of
     the sequence written as 8-bit grey PNGs with a KITTI
     ``calib_cam_to_cam.txt`` (``write_stereo_dir``); the port's native
     loader decodes each to uint8 / 255 within one f32 ulp (2^-23);
     ``poselib-test --compInitPose --showRect``: 3 frames within the
     accuracy bars, K1 and K2a 2 launches each per frame, the rectified
     PNGs at 512x1392, ``rectified_image`` on the card within 1e-5 of the
     same call on the CPU; ``poselib-test --stereoRef`` (seeded streams)
     in the same states as on the CPU; ``matchinglib-test``: each stored
     ``matches_XXXX.npz`` equal to ``get_correspondences`` on the card for
     the decoded pair; ``noMatch_poselib-test`` on
     ``eval/fixtures/semireal_fs`` plain, with ``--refineSOF --refineVFC``
     and with ``--stereoRef`` (seeded streams): the CSV header, the states
     and each row within 0.1 / 0.5 deg of the CPU's; ms per frame by stage
     and host syncs per frame for each CLI.
  9. the rest of the front end (``frontend_kernel_checks``,
     ``frontend_phase``): K2a bit-exact against its plain version at 2048 x
     2048 on the scene's 512-bit ring (BRISK) descriptors, xy_mode 0, 1
     and 2 with ~10% invalid columns and planted ties, at ``KNN2_RAGGED``
     x 2, 4 and 16 words, on the extreme pairs of the 512-bit key (an
     all-zero row against an all-ones column: distance 512 exact), and at
     17 words (64 x 64 random words); K2b at ``KNN2_L2_RAGGED`` x D = 200,
     120, 80, 48; K1 against its zero-padded plain version at every pixel
     of each pyramid level of the scene (levels 2-4), radius 0 and 3;
     then
     every row of ``frontend_rows`` (HARRIS, GFTT, STAR, MSD, MSER and
     pyramid ORB / BRISK at 4 levels with ORB; KAZE/KAZE; AKAZE/AKAZE;
     FAST t=12 with BRISK, FREAK, RIFF, BOLD, LATCH, BGM, BINBOOST_64 /
     _128 / _256, LBGM, VGG_120 / _80 / _64 / _48, DAISY) through
     ``StereoPipeline.run`` on the scene at 2048 slots, GMBSOF, 96 x 12
     hypotheses and seeded explicit streams: one warm run, launches as
     ``frontend_expected`` (K1 2, once per level and image on a pyramid,
     0 for the other detectors; K2a 2 for a binary descriptor but BOLD,
     K2b 2 for a float one) and no call of the plain ``fast_score``, the
     pose within the accuracy bars, timed
     runs with the stage split; the port's CPU path on the same pair for
     every detector row and ``FRONTEND_CPU_DESCRIPTORS`` (keypoints and
     match slots aligned by position, >= 99%); one profiled step of
     KAZE/KAZE and FAST/BRISK; ``run_batch`` on frames 1-2 at AKAZE/AKAZE
     and FAST/BOLD, each pair equal to its own ``run`` (slots 100%,
     inlier masks equal, 0.01 / 0.05 deg); ``matchinglib-test --f_detect
     AKAZE --d_extr AKAZE`` on phase 8's frames, each stored
     ``matches_XXXX.npz`` equal to ``get_correspondences`` on the card;
     a ``frontend`` line per row with the card's name and power limit,
     and the phase's wall seconds.
  10. the library layer (``library_kernel_checks``, ``library_phase``):
     K2b against its plain version at ``KNN2_L2_RAGGED`` x D = 2 and 3, and
     its times at 2048 x 2048 x 2 on pixel coordinates; the four library
     estimators (fundamental 7pt and 8pt, rotation-only, no-motion,
     QDEGSAC) on the flagship's card correspondences, normalized, and on a
     planted pure rotation (``planted_rotation``), seeded explicit streams,
     each on the card and on the CPU: the F rows by ``check_f_row`` (the
     same samples, the card's mask its model's rescoring on the CPU, its
     inliers >= 99% of the CPU's; each hypothesis's distance from its
     sample's float64 solve and its residual reported on both devices, and
     for 8pt the batched essential 8pt's card-vs-CPU distance), every row's
     inlier mask on >= 99% of slots (no-motion's equal), R within 1e-4,
     QDEGSAC's decision equal (true on the planted rotation) and its E's
     pose within phase 4d's bars; ``lk_flow`` from the left image of frame
     1 to itself shifted by (6, -4) px at the flagship's 2048 keypoints
     (status on >= 80%, median error < 0.25 px), LKOF (K2b at D = 2, once)
     and ALKOF (K2a guided, once) from frame 1's left image to frame 2's,
     card vs CPU (flow within 0.02 px and status on >= 99%, masks and match
     slots on >= 99% outside near ties of 1 px^2), K2b against its plain
     version at D = 2 on those coordinates; ``MatchingPoselibNode`` on
     frames 1-3, plain and with stereoRef + evStepStereoStable = 2 (seeded
     streams), each pose within the accuracy bars, the CPU node fed the
     card's correspondences within phase 4d's bars and the same republish
     pattern; ``entry()``'s step under ``utils.profiling.trace`` (a
     non-empty trace file); the example on frames 1-3 as PNGs; ``library``
     lines with ms per call, host syncs and device ops, the card's name and
     power limit, and the phase's wall seconds.
  11. distribution (``distribution_phase``), each rank a process of its
     own that loads phase 1's kernels (``dist_rank``, ``run_world``; 300 s
     per world at most): (a) a world of 1 over NCCL on cuda:0, (b) a world
     of 2 ranks sharing cuda:0 over gloo (the compute on the card, the
     collectives through gloo), (c) with 2 or more cards NCCL with one
     rank per card (2 or 4; on one card it prints that (c) was not run).
     Each world: ``sharded_match`` of the scene's 2048 right-image ORB
     descriptors against a seeded db of 1,048,576 rows (8 words, the left
     image's descriptors planted at spread rows) over the db ranks, equal
     bit for bit to the kernels over the whole db in this process
     (``match_descriptors`` without the ratio fallback) and to
     ``knn2_plain`` on 3 slices of 64 query rows, K2a 2 launches per call
     per rank; the same for SIFT 2048 x 128 against 262,144 unit rows at
     phase 3b's bars (K2b 2 launches); ``bundle_adjust_sharded`` on a
     keyframe window (``dist_ba_problem``: 10 cameras of the sequence's
     rig, 16,384 points, ~70% seen, cameras 1-9 turned by 0.5 deg, 8
     iterations): every camera within 0.05 deg of the planted pose and
     within 5e-4 of single-card ``bundle_adjust``, in (a) with no host
     read under ``set_sync_debug_mode("error")``; ``dryrun_multichip``;
     every rank's outputs the same bits. (b) and (c) also: the consensus
     over phase 6's 10 frames on a (world x 1) mesh within 0.2 / 1.0 deg
     of phase 6's most-likely pose; phase 7's 8 pairs split over the
     pairs ranks through ``run_batch``, each pair equal to phase 7's
     (slots 100%, masks equal, 0.01 / 0.05 deg), K1 once and K2a twice a
     pair per rank. ``distribution`` lines per world and function (ms per
     call per rank of 3 after a warm one, host clock ending in a sync; ms
     in the collectives and their count; launches, host syncs, device ops
     and busy ms; BA's all-reduces per LM iteration) with the card's name
     and power limit, and the phase's wall seconds.

  12. the kernels over the JAX package's whole input domain
     (``domains_phase``): K1 at t = -12/255 and -1/255 (its own
     instantiation), radius 0 and 3, at every pixel of the scene's (1, 512,
     1392) and (2, 512, 1392) stacks and of a half-flat image against the
     zero-padded plain version, max abs err 0 and no tie mismatch; K2a with
     the scene's 2048 right-image ORB descriptors against seeded maps of
     2,097,153, 4,194,304 and 16,781,312 rows (8 words) and its BRISK ones
     against 1,048,577 and 8,388,609 rows (16 words), the left image's
     descriptors planted past the column-field and launch boundaries,
     exact duplicates on both sides of a slice and a launch boundary,
     unguided and at xy_mode 1 and 2: 64 query rows bit-exact against the
     plain version chunk by chunk (``plain_chunked``), the planted matches
     found again; K2a at 17, 24, 32 and 64 words at 2048 x 2048,
     ``KNN2_RAGGED`` and the key's extreme pairs, and on unaligned views,
     bit-exact; K2b at D = 641, 1024 and 2048 at 2048 x 2048 and
     ``KNN2_L2_RAGGED`` at phase 3b's bars, and through 3 column chunks;
     ``sharded_match`` in a world of one over NCCL against the
     16,781,312-row map (every field of every row equal to the plain
     search and the JAX package's merge rule) and against 65,536 float
     rows of 1024 (phase 11's bars). Launches per call, device ms and the
     bound per launch of each new shape (``domains`` lines and the
     ``domains`` key of each kernel in the ``kernels`` line), and the
     phase's wall seconds.

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
# phase 4e: card vs CPU on each filter from the same correspondences
# (subpix shifts in px; shares of valid / all slots)
SUBPIX_SHIFT_TOL = 1e-3
FILTER_AGREE = 0.99
# phase 7b: pairs of the sequence run as one batch with the options
BATCH_OPTION_PAIRS = 2
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


# traces taken at most for one device time: now and then a trace records
# no kernel at all (3 tries in a row did once, in phase 10's K2b check)
DEVICE_PROFILE_TRIES = 6


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


def _device_profile(torch, fn, iters=10, tries=DEVICE_PROFILE_TRIES,
                    name=None):
    """(device ms, device ops) per call of `fn`, from torch.profiler: the
    summed time of every kernel it launches (or only of those whose name
    holds `name`), which unlike CUDA events around back-to-back calls
    leaves out the gaps where the card waits for the host to launch, and
    the number of those kernels. Now and then a trace records no kernel
    at all, or drops one (a count that is not a whole number per call);
    it is taken again, up to `tries` traces. If none records a kernel,
    (None, None) (not measured); if each drops one, the last trace's
    numbers."""
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
                  if e.device_type.name == "CUDA"
                  and (name is None or name in e.key)]
        ms = sum(e.self_device_time_total for e in device) / 1e3 / iters
        count = sum(e.count for e in device)
        if ms > 0:
            out = ms, count / iters
            if count % iters == 0:
                break
    return out


def _device_ms(torch, fn, iters=10, tries=DEVICE_PROFILE_TRIES):
    """Device ms per call of `fn` (`_device_profile`)."""
    return _device_profile(torch, fn, iters, tries)[0]


def _device_events(torch, step):
    """One call of `step` under torch.profiler, device activity only (the
    host ops' events would double what ``key_averages`` sorts, ~80 us per
    event on the host, and the device numbers do not need them): (its
    device events by summed device time, wall ms of the profiled call,
    which the profiler itself slows)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device = sorted((e for e in prof.key_averages()
                     if e.device_type.name == "CUDA"),
                    key=lambda e: -e.self_device_time_total)
    return device, wall_ms


def _profile_step(torch, step):
    """One step under torch.profiler: (device-busy ms = summed device
    time of its kernels and copies, number of device ops, wall ms of the
    profiled step)."""
    device, wall_ms = _device_events(torch, step)
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    return busy_ms, sum(e.count for e in device), wall_ms


def _kernel_split(torch, fn, top=6):
    """A warm call of `fn`, then one under torch.profiler: (device-busy
    ms, device ops, [[kernel name, ms, launches]] of its `top` kernels by
    summed device time)."""
    fn()
    device, _ = _device_events(torch, fn)
    return (sum(e.self_device_time_total for e in device) / 1e3,
            sum(e.count for e in device),
            [[e.key[:80], e.self_device_time_total / 1e3, e.count]
             for e in device[:top]])


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


def knn2_ragged_cases(torch, rng, dev, width=8):
    """K2a cases at the ragged shapes, xy_mode 0, 1 and 2: random words
    (`width` per descriptor), ~10% invalid columns, planted ties where n2
    allows, and the last quarter of the rows (at least one) predicted far
    outside every gate; plus, at 17 x 70, every column invalid. Returns
    [(label, xy_mode, args, rows that must come out exactly (1e9, 1e9,
    -1))]."""
    def words(n):
        return torch.from_numpy(rng.integers(-2**31, 2**31, (n, width),
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
            label = (f"{n1}x{n2}" + (f"x{width}w" if width != 8 else "")
                     + (" all invalid" if all_invalid else ""))
            cases.append((label, mode, args, faulted))
    return cases


def knn2_extreme_cases(torch, dev, width=16):
    """K2a at the ends of the key's distance field (0..2 * 32 W): an
    all-zero query against an all-ones candidate (the field's largest
    value), an all-ones query against an all-zero candidate, two equal
    extreme candidates (a tie at the largest distance) and an invalid
    nearer one. Returns [(label, args, (d_best, d_second, idx) exactly)]."""
    bits = 32 * width

    def rows(*vals):
        return torch.tensor([[v] * width for v in vals], dtype=torch.int32,
                            device=dev)

    def valid(*v):
        return torch.tensor(v, dtype=torch.bool, device=dev)

    return [
        ("zero row vs ones column",
         (rows(0), rows(0, -1), valid(False, True)), (float(bits), 1e9, 1)),
        ("ones row vs zero column",
         (rows(-1), rows(-1, 0), valid(False, True)), (float(bits), 1e9, 1)),
        ("tie of two ones columns", (rows(0), rows(0, -1, -1),
                                     valid(False, True, True)),
         (float(bits), float(bits), 1)),
    ]


def check_knn2_extreme(torch, knn2, cases):
    """K2a vs plain on the extreme cases, bit-exact, and the exact
    expected (d_best, d_second, idx) of each."""
    for label, args, want in cases:
        got = knn2.knn2(*args)
        plain = knn2.knn2_plain(*args)
        for name, g, w in zip(("d_best", "d_second", "idx"), got, plain):
            if not torch.equal(g, w):
                raise AssertionError(f"knn2 {label}: {name} differs from "
                                     "the plain version")
        vals = (float(got[0][0]), float(got[1][0]), int(got[2][0]))
        if vals != want:
            raise AssertionError(f"knn2 {label}: {vals}, expected {want}")


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


def knn2_l2_ragged_cases(torch, rng, dev, depths=KNN2_L2_DEPTHS):
    """K2b cases at the ragged shapes and depths, xy_mode 0, 1 and 2:
    random unit rows, ~10% invalid columns, the last quarter of the rows
    predicted far outside every gate; planted duplicates of a query (two
    valid columns on its predicted position), one pair inside one tile of
    the first column slice and one pair across the first and the last
    slice; plus, at 17 x 70, every column invalid, or (xy_mode 1 and 2)
    every row gated. Returns [(label, xy_mode, args, planted (queries, low
    columns), rows that must come out exactly (1e9, 1e9, -1))]; at each of
    `depths`."""
    def unit(n, depth):
        x = rng.normal(size=(n, depth)).astype(np.float32)
        return torch.from_numpy(x / np.linalg.norm(x, axis=1, keepdims=True))

    cases = []
    shapes = ([(s, None) for s in KNN2_L2_RAGGED]
              + [((17, 70), "invalid"), ((17, 70), "gated")])
    for depth in depths:
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


def pose_menu(cfg, robust):
    """Phase 4d's branches: (name, PoseConfig changes, accuracy bars); the
    robust menu's rows change `robust` (the RobustConfig they start
    from)."""
    return (
        ("AutoTh", dict(auto_th=True), (MAX_ROT_DEG, MAX_TANG_DEG)),
        # the JAX package's own bars for Halign
        # (tests/test_pose_branches.py:132)
        ("Halign", dict(use_halign=True), (3.0, 10.0)),
        ("BA", dict(ba=cfg.BAConfig(enabled=True, iterations=20)),
         (MAX_ROT_DEG, MAX_TANG_DEG)),
        ("Kneip", dict(refine=cfg.RefinementConfig(
            solver=cfg.MinimalSolver.KNEIP)), (MAX_ROT_DEG, MAX_TANG_DEG)),
        ("LMEDS", dict(robust=dataclasses.replace(
            robust, estimator=cfg.PoseEstimator.LMEDS)),
         (MAX_ROT_DEG, MAX_TANG_DEG)),
        ("Stewenius", dict(robust=dataclasses.replace(
            robust, solver=cfg.MinimalSolver.STEWENIUS_5PT)),
         (MAX_ROT_DEG, MAX_TANG_DEG)),
    )


def match_menu(cfg, match):
    """Phase 4e's matching options: (name, MatchingConfig, launches of
    each kernel on the path). `match`: the flagship's MatchingConfig."""
    return (
        ("subpix+VFC", dataclasses.replace(match, subpix_refine=True,
                                           vfc_filter=True),
         {"fast_nms": 2, "knn2": 2, "knn2_l2": 0}),
        # a matcher other than GMBSOF: the ratio pass only, one K2a launch
        ("SOF filter", cfg.MatchingConfig(matcher_name="FLANN",
                                          sof_filter=True),
         {"fast_nms": 2, "knn2": 1, "knn2_l2": 0}),
    )


def filters_card_vs_cpu(torch, pipeline, img1, img2, det, desc, match):
    """Each filter of `match` again on the card and on the CPU from the
    same inputs: the card's correspondences before the filters, and for
    VFC the card's refined points. Sub-pixel refinement: shifts within
    SUBPIX_SHIFT_TOL px on >= FILTER_AGREE of the valid slots, success on
    >= FILTER_AGREE of the slots, pass_ok equal; VFC and the SOF filter:
    masks on >= FILTER_AGREE of the slots. On the card, subpix and VFC
    are also profiled alone (``_kernel_split``). Returns (record,
    failures)."""
    from matchinglib_poselib_torch.ops import filters, subpix

    pre = pipeline.get_correspondences(
        img1, img2, det, desc, dataclasses.replace(
            match, sof_filter=False, subpix_refine=False, vfc_filter=False))
    shape = tuple(img1.shape)
    cpu = {k: getattr(pre, k).cpu() for k in ("pts1", "pts2", "mask")}
    valid = cpu["mask"]
    rec = {"slots_in": int(valid.sum())}
    failures = []

    def share(name, a, b, over=None):
        same = (a.cpu() == b) if over is None else over
        rec[name] = float(same.float().mean())
        if rec[name] < FILTER_AGREE:
            failures.append(f"card vs CPU {name}: {rec[name]:.4f}")

    pts2 = pre.pts2
    if match.sof_filter and match.matcher_name.upper() != "GMBSOF":
        kw = dict(cell_px=match.sof_grid_px,
                  validation_th=match.sof_validation_th)
        sof = filters.sof_filter_matches(pre.pts1, pre.pts2, pre.mask,
                                         shape, **kw)
        share("sof_filter_mask", sof, filters.sof_filter_matches(
            cpu["pts1"], cpu["pts2"], cpu["mask"], shape, **kw))
        rec["sof_filter_kept"] = int(sof.sum())
    if match.subpix_refine:
        sp = subpix.refine_matches_subpix(img1, img2, pre.pts1, pre.pts2,
                                          pre.mask)
        sp_cpu = subpix.refine_matches_subpix(
            img1.cpu(), img2.cpu(), cpu["pts1"], cpu["pts2"], cpu["mask"])
        close = (sp.shift.cpu() - sp_cpu.shift).abs().amax(-1) <= (
            SUBPIX_SHIFT_TOL)
        share("subpix_shift", None, None, over=close[valid])
        rec["subpix_shift_max_px"] = float(
            (sp.shift.cpu() - sp_cpu.shift).abs().amax(-1)[valid].max())
        share("subpix_success", sp.success, sp_cpu.success)
        rec["subpix_pass_ok"] = [bool(sp.pass_ok), bool(sp_cpu.pass_ok)]
        if len(set(rec["subpix_pass_ok"])) != 1:
            failures.append(f"card vs CPU subpix pass {rec['subpix_pass_ok']}")
        rec["subpix_refined"] = int((sp.success & sp.pass_ok).sum())
        if img1.is_cuda:
            rec["subpix_profiled"] = _kernel_split(
                torch, lambda: subpix.refine_matches_subpix(
                    img1, img2, pre.pts1, pre.pts2, pre.mask))
        pts2 = sp.pts2
    if match.vfc_filter:
        args = (filters.to_unit(pre.pts1, shape),
                filters.to_unit(pts2, shape), pre.mask)
        vfc = filters.vfc_filter(*args)
        vfc_cpu = filters.vfc_filter(*(a.cpu() for a in args))
        share("vfc_mask", vfc.inlier_mask, vfc_cpu.inlier_mask)
        rec["vfc_probability_max_diff"] = float(
            (vfc.probabilities.cpu() - vfc_cpu.probabilities).abs().max())
        rec["vfc_kept"] = int(vfc.inlier_mask.sum())
        if img1.is_cuda:
            rec["vfc_profiled"] = _kernel_split(
                torch, lambda: filters.vfc_filter(*args))
    return rec, failures


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


def match_phase(torch, cfg, det, desc, match, pose_cfg, imgs, Kt, dist,
                truth, seed):
    """Phase 4e: each of ``match_menu`` through ``drive_path`` with seeded
    explicit streams (the launches checked), the CPU path's slots against
    the card's (``cpu_agreement``), and each filter on the card against
    the CPU (``filters_card_vs_cpu``). Returns ([(name, step record)],
    failures)."""
    from matchinglib_poselib_torch.models import pipeline
    from matchinglib_poselib_torch.ops import kernels, robust

    (img1, img2), (i1, i2) = imgs
    steps, failures = [], []
    for m_i, (name, m_cfg, expected) in enumerate(match_menu(cfg, match)):
        t_phase = time.perf_counter()
        streams = pose_streams(torch, robust, pose_cfg, seed + 20 + m_i)
        pipe = pipeline.StereoPipeline(det, desc, m_cfg, pose_cfg,
                                       device=i1.device)
        (c, _), rec, fails = drive_path(
            torch, kernels, pipe, i1, i2, Kt, dist, None, truth, expected,
            POSE_TIMED_RUNS, streams=streams)
        failures.extend(f"{name}: {f}" for f in fails)
        t0 = time.perf_counter()
        rec["cpu_agree"] = cpu_agreement(torch, pipeline, c, img1, img2, det,
                                         desc, m_cfg)
        rec["filters_card_vs_cpu"], fails = filters_card_vs_cpu(
            torch, pipeline, i1, i2, det, desc, m_cfg)
        rec["cpu_check_s"] = time.perf_counter() - t0
        failures.extend(f"{name}: {f}" for f in fails)
        rec["phase_s"] = time.perf_counter() - t_phase
        steps.append((name, rec))
    return steps, failures


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
    return record, failures, (results, [p["n_corr"] for p in per_frame])


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
    return record, failures, (corr, pose, (imgs1, imgs2, Kt, U, D))


def batch_options_phase(torch, det, desc, match, pose_cfg, dev, seed):
    """Phase 7b: ``run_batch`` on the sequence's first BATCH_OPTION_PAIRS
    pairs with `match` and `pose_cfg` (the options together), seeded
    explicit streams: counters from 0, one batch, counters read back (K1
    once, K2a twice per pair); both pairs within the accuracy bars; each
    pair equal to ``run`` of that pair on the card (``batch_vs_run``).
    Returns (step record, failures)."""
    from matchinglib_poselib_torch.models import pipeline
    from matchinglib_poselib_torch.ops import kernels, robust
    from matchinglib_poselib_torch.utils.profiling import HostSyncs

    t_phase = time.perf_counter()
    pairs, K, R_true, t_true = _sequence(seed)
    pairs = pairs[:BATCH_OPTION_PAIRS]
    P = len(pairs)
    imgs1 = torch.from_numpy(np.stack([a for a, _ in pairs])).to(dev)
    imgs2 = torch.from_numpy(np.stack([b for _, b in pairs])).to(dev)
    Kt = torch.from_numpy(K).to(dev)
    dist = torch.zeros(5, device=dev)
    U, D = batch_streams(torch, robust, pose_cfg, seed + 40, P)
    pipe = pipeline.StereoPipeline(det, desc, match, pose_cfg, device=dev)
    # the main path: counts set to 0 just before, read just after
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with HostSyncs.traced() as log:
        corr, pose = pipe.run_batch(imgs1, imgs2, Kt, Kt, dist, dist,
                                    uniforms=U, degen_uniforms=D)
    torch.cuda.synchronize()
    batch_ms = (time.perf_counter() - t0) * 1e3
    launches = kernels.launch_counts()
    expected = {"fast_nms": 1, "knn2": 2 * P, "knn2_l2": 0}
    failures = [f"{k} launched {launches[k]} times in the batch (expected "
                f"{v})" for k, v in expected.items() if launches[k] != v]
    if not bool(torch.isfinite(pose.R).all() and torch.isfinite(pose.t).all()
                and torch.isfinite(corr.pts2).all()):
        failures.append("non-finite pose or correspondences")
    per_pair = []
    for i in range(P):
        row = {"n_corr": int(corr.n[i]), "n_inliers": int(pose.n_inliers[i]),
               "n_models_generated": int(pose.n_models_generated[i]),
               "rot_err_deg": _rot_deg(R_true, pose.R[i].cpu().numpy()),
               "t_err_deg": _dir_deg(t_true, pose.t[i].cpu().numpy())}
        per_pair.append(row)
        if (row["rot_err_deg"] >= MAX_ROT_DEG
                or row["t_err_deg"] >= MAX_TANG_DEG
                or row["n_corr"] < MIN_CORR
                or row["n_inliers"] < MIN_INLIERS):
            failures.append(f"pair {i + 1} off the accuracy bars: {row}")
    singles = []
    t0 = time.perf_counter()
    for i in range(P):
        singles.append(pipe.run(imgs1[i], imgs2[i], Kt, Kt, dist, dist,
                                uniforms=U[i], degen_uniforms=D[i]))
    torch.cuda.synchronize()
    runs_ms = (time.perf_counter() - t0) * 1e3
    vs_run, fails = batch_vs_run(torch, corr, pose, singles)
    failures += fails
    record = {"pairs": P, "launches": launches, "host_syncs_per_batch":
              len(log), "per_pair": per_pair, "batch_vs_run": vs_run,
              "batch_ms": batch_ms, "pairs_one_by_one_ms": runs_ms,
              "phase_s": time.perf_counter() - t_phase}
    return record, failures


# phase 7c: run_batch with each of phase 4d's pose branches (AutoTh,
# Halign, BA, Kneip) on frames 1-BRANCH_BATCH_PAIRS of the sequence, at
# the PoseConfig phase 4d uses for it; timed batches after the warm one
BRANCH_BATCH_PAIRS = 4
BRANCH_BATCH_TIMED_RUNS = 3
BRANCH_BATCH_NAMES = ("AutoTh", "Halign", "BA", "Kneip")


def branch_streams(torch, robust, pose_cfg, seed, pairs):
    """Seeded explicit streams of a batch for any pose branch: pair i's
    from ``pose_streams`` with seed + i, stacked on a leading pair axis."""
    per = [pose_streams(torch, robust, pose_cfg, seed + i)
           for i in range(pairs)]
    return {k: torch.stack([p[k] for p in per]) for k in per[0]}


def branch_batch_phase(torch, cfg, det, desc, match, pose_cfg, dev, seed,
                       smi):
    """Phase 7c: for each of BRANCH_BATCH_NAMES, ``run_batch`` on the
    sequence's first BRANCH_BATCH_PAIRS pairs at that branch's phase-4d
    PoseConfig with seeded explicit streams (``branch_streams``): counters
    from 0, one batch, counters read back (K1 once, K2a twice per pair);
    every pair within the branch's accuracy bars; each pair equal to its
    own ``run`` on the card (``batch_vs_run``), the pairs' ``run`` timed
    one by one; BRANCH_BATCH_TIMED_RUNS timed batches; host syncs of the
    batch; device ops and busy ms of one profiled batch. Returns ({branch:
    record}, failures)."""
    from matchinglib_poselib_torch.models import pipeline
    from matchinglib_poselib_torch.ops import kernels, robust
    from matchinglib_poselib_torch.utils.profiling import HostSyncs

    t_phase = time.perf_counter()
    pairs, K, R_true, t_true = _sequence(seed)
    pairs = pairs[:BRANCH_BATCH_PAIRS]
    P = len(pairs)
    imgs1 = torch.from_numpy(np.stack([a for a, _ in pairs])).to(dev)
    imgs2 = torch.from_numpy(np.stack([b for _, b in pairs])).to(dev)
    Kt = torch.from_numpy(K).to(dev)
    dist = torch.zeros(5, device=dev)
    menu = {name: (change, bars) for name, change, bars
            in pose_menu(cfg, pose_cfg.robust)}
    records, failures = {}, []
    for b_i, name in enumerate(BRANCH_BATCH_NAMES):
        t_branch = time.perf_counter()
        change, bars = menu[name]
        b_cfg = dataclasses.replace(pose_cfg, **change)
        streams = {k: v.to(dev) for k, v in branch_streams(
            torch, robust, b_cfg, seed + 50 + 10 * b_i, P).items()}
        pipe = pipeline.StereoPipeline(det, desc, match, b_cfg, device=dev)

        def batch():
            return pipe.run_batch(imgs1, imgs2, Kt, Kt, dist, dist,
                                  **streams)

        # the main path: counts set to 0 just before, read just after
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with HostSyncs.traced() as log:
            corr, pose = batch()
        torch.cuda.synchronize()
        warm_ms = (time.perf_counter() - t0) * 1e3
        launches = kernels.launch_counts()
        fails = [f"{k} launched {launches[k]} times in the batch (expected "
                 f"{v})" for k, v in {"fast_nms": 1, "knn2": 2 * P,
                                      "knn2_l2": 0}.items()
                 if launches[k] != v]
        if not bool(torch.isfinite(pose.R).all()
                    and torch.isfinite(pose.t).all()):
            fails.append("non-finite pose")
        per_pair = []
        for i in range(P):
            row = {"n_corr": int(corr.n[i]),
                   "n_inliers": int(pose.n_inliers[i]),
                   "halign_error_code": int(pose.halign_error_code[i]),
                   "rot_err_deg": _rot_deg(R_true, pose.R[i].cpu().numpy()),
                   "t_err_deg": _dir_deg(t_true, pose.t[i].cpu().numpy())}
            per_pair.append(row)
            if (row["rot_err_deg"] >= bars[0] or row["t_err_deg"] >= bars[1]
                    or row["n_corr"] < MIN_CORR
                    or row["n_inliers"] < MIN_INLIERS):
                fails.append(f"pair {i + 1} off the accuracy bars: {row}")
        # each pair alone through run, with its own streams, timed
        singles, run_ms = [], []
        for i in range(P):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            singles.append(pipe.run(imgs1[i], imgs2[i], Kt, Kt, dist, dist,
                                    **{k: v[i] for k, v in streams.items()}))
            torch.cuda.synchronize()
            run_ms.append((time.perf_counter() - t0) * 1e3)
        vs_run, f = batch_vs_run(torch, corr, pose, singles)
        fails += f
        batch_ms = []
        for _ in range(BRANCH_BATCH_TIMED_RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batch()
            torch.cuda.synchronize()
            batch_ms.append((time.perf_counter() - t0) * 1e3)
        busy_ms, device_ops, prof_wall_ms = _profile_step(torch, batch)
        failures.extend(f"{name}: {x}" for x in fails)
        records[name] = {
            "pairs": P, "card": smi, "launches": launches,
            "host_syncs_per_batch": len(log), "warm_ms": warm_ms,
            "runs": BRANCH_BATCH_TIMED_RUNS,
            "ms_mean": float(np.mean(batch_ms)),
            "ms_median": float(np.median(batch_ms)), "batch_ms": batch_ms,
            "pairs_one_by_one_ms": float(np.sum(run_ms)),
            "run_ms": run_ms, "per_pair": per_pair, "batch_vs_run": vs_run,
            "profiled_batch": {"wall_ms": prof_wall_ms,
                               "device_busy_ms": busy_ms,
                               "device_ops": device_ops},
            "branch_s": time.perf_counter() - t_branch}
    return records, failures, time.perf_counter() - t_phase


# ---------------------------------------------------------------------------
# phase 8: the CLIs on files
# ---------------------------------------------------------------------------


def kitti_calib_text(K, R, t, dist=np.zeros(5)) -> str:
    """A KITTI calib_cam_to_cam.txt for the rig: camera 0 at the origin,
    camera 1 at X2 = R X1 + t, both with intrinsics K (the K_xx, D_xx,
    R_xx, T_xx rows that ``utils.io.load_kitti_calib`` reads)."""
    def row(name, v):
        return f"{name}: " + " ".join(f"{x:.12e}" for x in np.ravel(v))

    return "\n".join([
        row("K_00", K), row("D_00", dist), row("R_00", np.eye(3)),
        row("T_00", np.zeros(3)), row("K_01", K), row("D_01", dist),
        row("R_01", R), row("T_01", t)]) + "\n"


def write_stereo_dir(directory, pairs, K, R, t):
    """Write pairs of float images in [0, 1] as 8-bit grey PNGs
    ``left_XXXX.png`` / ``right_XXXX.png`` (the port's ``write_png``) and
    the rig's ``calib_cam_to_cam.txt`` into `directory`, the layout
    ``poselib-test`` reads. Returns the written uint8 images, [(left,
    right), ...]."""
    import pathlib

    from matchinglib_poselib_torch.utils import visualize

    d = pathlib.Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    written = []
    for i, pair in enumerate(pairs):
        u8 = [np.round(np.clip(im, 0.0, 1.0) * 255.0).astype(np.uint8)
              for im in pair]
        for side, im in zip(("left", "right"), u8):
            visualize.write_png(d / f"{side}_{i:04d}.png", im)
        written.append(tuple(u8))
    (d / "calib_cam_to_cam.txt").write_text(kitti_calib_text(K, R, t))
    return written


# phase 8: frames of the sequence the CLIs read; the loader's bar (the
# BT.601 sum 0.299 v + 0.587 v + 0.114 v is v within one f32 ulp below 1);
# card vs CPU on rectified_image from the same inputs; card vs CPU on the
# noMatch CLI's rows and the --stereoRef states (phase 4d's bars); the
# noMatch runs on the repo's FileStorage fixture
APP_FRAMES = 3
LOADER_ATOL = 2.0 ** -23
RECT_CARD_CPU_ATOL = 1e-5
NOMATCH_RUNS = (("plain", []), ("SOF + VFC", ["--refineSOF", "--refineVFC"]),
                ("stereoRef", ["--stereoRef"]))


def _cli(torch, main, argv, **kw):
    """One in-process CLI run with its stdout captured: (stdout lines,
    wall s, kernel launches, host syncs). Fails on a non-zero exit."""
    import contextlib
    import io

    from matchinglib_poselib_torch.ops import kernels
    from matchinglib_poselib_torch.utils.profiling import HostSyncs

    kernels.reset_launch_counts()
    syncs0 = HostSyncs.count
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(argv, **kw)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"{main.__module__}.main({argv}) exited {rc}")
    return (buf.getvalue().strip().splitlines(), wall,
            kernels.launch_counts(), HostSyncs.count - syncs0)


def _png_hw(path):
    """(height, width) from a PNG's IHDR chunk."""
    head = path.read_bytes()[16:24]
    return int.from_bytes(head[4:8], "big"), int.from_bytes(head[:4], "big")


def _csv_rows(path):
    import csv

    with open(path) as f:
        reader = csv.reader(f, delimiter=";")
        header = next(reader)
        return header, [dict(zip(header, row)) for row in reader]


def _check_loader(native, d, written):
    """The port's loader on every written PNG against uint8 / 255. Returns
    (max abs error, failures)."""
    if not native.available():
        return None, [f"the native loader did not build: "
                      f"{native.BUILD_ERROR[-800:]}"]
    err, failures = 0.0, []
    for i, pair in enumerate(written):
        for side, u8 in zip(("left", "right"), pair):
            got = native.load_image_gray(d / f"{side}_{i:04d}.png")
            if got is None or got.shape != u8.shape:
                failures.append(f"loader: {side}_{i:04d}.png not decoded")
                continue
            want = u8.astype(np.float32) / np.float32(255.0)
            err = max(err, float(np.abs(got - want).max()))
    if err > LOADER_ATOL:
        failures.append(f"loader: max abs {err} against uint8 / 255")
    return err, failures


def _rectify_card_vs_cpu(torch, rectify, tio, d, K, R, t, dev):
    """Frame 1's left image rectified for the planted rig on the card and
    on the CPU from the same inputs: (record, failures)."""
    img = torch.from_numpy(tio.load_image_gray(d / "left_0000.png")).to(dev)
    Kt = torch.as_tensor(K, dtype=torch.float32, device=dev)
    z = torch.zeros(5, device=dev)
    Rt = torch.as_tensor(R, dtype=torch.float32, device=dev)
    tt = torch.as_tensor(t, dtype=torch.float32, device=dev)
    hw = tuple(img.shape)
    rect = rectify.get_rectification_parameters(Kt, Kt, Rt, tt, z, z, hw)
    rect_cpu = rectify.get_rectification_parameters(
        *(x.cpu() for x in (Kt, Kt, Rt, tt, z, z)), hw)
    args = (img, Kt, z, rect.R1, rect.K_new1, hw)
    card = rectify.rectified_image(*args)
    cpu = rectify.rectified_image(*(a.cpu() if hasattr(a, "cpu") else a
                                    for a in args))
    rec = {
        "max_abs_err": float((card.cpu() - cpu).abs().max()),
        "fields_max_abs_diff": max(
            float((getattr(rect, f).cpu() - getattr(rect_cpu, f)).abs().max())
            for f in rect._fields),
        "filled": float((card > 0).float().mean()),
    }
    if dev.type == "cuda":
        rec["ms"] = _cuda_ms(torch, lambda: rectify.rectified_image(*args),
                             iters=10)
        rec["params_ms"] = _cuda_ms(
            torch, lambda: rectify.get_rectification_parameters(
                Kt, Kt, Rt, tt, z, z, hw), iters=10)
    failures = []
    if rec["max_abs_err"] > RECT_CARD_CPU_ATOL:
        failures.append(f"rectified_image card vs CPU: max abs "
                        f"{rec['max_abs_err']}")
    if rec["filled"] < 0.8:
        failures.append(f"rectified_image: only {rec['filled']:.3f} filled")
    return rec, failures


def apps_phase(torch, dev, seed, smi, size=(HEIGHT, WIDTH)):
    """Phase 8: the three CLIs on files, in-process on `dev` (the card;
    the CPU rehearses it, ``chip_probes/apps_rehearsal.py``), each
    comparison's second run on the CPU; images of `size` (see the module
    docstring). Returns (record, failures)."""
    import pathlib
    import tempfile

    from matchinglib_poselib_torch import native
    from matchinglib_poselib_torch.apps import (
        common, matchinglib_test, nomatch_poselib_test, poselib_test)
    from matchinglib_poselib_torch.models import pipeline
    from matchinglib_poselib_torch.ops import rectify, robust
    from matchinglib_poselib_torch.utils import io as tio

    t_phase = time.perf_counter()
    failures = []
    rec = {"card": smi, "frames": APP_FRAMES}
    height, width = size
    pairs, K, R, t = render_sequence(seed, APP_FRAMES, width, height)
    fs_dir = pathlib.Path(__file__).resolve().parent / "eval" / "fixtures" \
        / "semireal_fs"
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        d = tmp / "imgs"
        written = write_stereo_dir(d, pairs, K, R, t)
        rec["loader_max_abs_err"], fails = _check_loader(native, d, written)
        failures.extend(fails)
        img_args = ["--img_path", str(d)]

        # poselib-test --compInitPose --showRect, the CLI's own samples
        out = tmp / "pose"
        lines, wall, launches, syncs = _cli(
            torch, poselib_test.main,
            img_args + ["--compInitPose", "--showRect", "--output_path",
                        str(out)], device=dev)
        frames = [json.loads(x) for x in lines[:-1]]
        summary = json.loads(lines[-1])
        rec["poselib_test"] = {
            "frames": frames, "wall_s": wall, "launches": launches,
            "host_syncs_per_frame": syncs / APP_FRAMES,
            "ms_per_frame": {k: v / APP_FRAMES
                             for k, v in summary["stage_ms"].items()}}
        if len(frames) != APP_FRAMES:
            failures.append(f"poselib-test: {len(frames)} frame lines")
        for f in frames:
            if not (f["R_diff_deg"] < MAX_ROT_DEG
                    and f["t_angDiff_deg"] < MAX_TANG_DEG):
                failures.append(f"poselib-test frame {f['frame']}: "
                                f"{f['R_diff_deg']} / {f['t_angDiff_deg']}"
                                " deg against the planted pose")
        for i in range(APP_FRAMES):
            for name, hw in (("rect_left", size), ("rect_right", size),
                             ("rect_pair", (height, 2 * width))):
                path = out / f"{name}_{i:04d}.png"
                if not path.exists() or _png_hw(path) != hw:
                    failures.append(f"poselib-test: {path.name} missing or "
                                    "not " + "x".join(map(str, hw)))
        rec["rectified_image"], fails = _rectify_card_vs_cpu(
            torch, rectify, tio, d, K, R, t, dev)
        failures.extend(fails)

        # the same samples on the card and the CPU for the comparisons
        saved = common.frame_streams, common.stereo_refine_streams
        common.frame_streams = lambda i, cfg: pose_streams(
            torch, robust, cfg, seed + 100 + i)
        common.stereo_refine_streams = lambda cfg: SeededStreams(
            torch, cfg.pose.robust, seed + 200)
        try:
            sr_args = img_args + ["--stereoRef", "--compInitPose"]
            lines, wall, launches, syncs = _cli(torch, poselib_test.main,
                                                sr_args, device=dev)
            t0 = time.perf_counter()
            lines_cpu = _cli(torch, poselib_test.main, sr_args,
                             device="cpu")[0]
            card_f = [json.loads(x) for x in lines[:-1]]
            cpu_f = [json.loads(x) for x in lines_cpu[:-1]]
            rec["poselib_test_stereoRef"] = {
                "frames": card_f, "wall_s": wall, "launches": launches,
                "cpu_rerun_s": time.perf_counter() - t0,
                "host_syncs_per_frame": syncs / APP_FRAMES,
                "ms_per_frame": {
                    k: v / APP_FRAMES
                    for k, v in json.loads(lines[-1])["stage_ms"].items()}}
            states = [f["state"] for f in card_f]
            if states != [f["state"] for f in cpu_f] or states[0] != "init":
                failures.append(f"poselib-test --stereoRef: states {states} "
                                f"on the card, {[f['state'] for f in cpu_f]}"
                                " on the CPU")
            for f in card_f:
                if f["state"] in ACCEPTED and not (
                        f["R_diff_deg"] < MAX_ROT_DEG
                        and f["t_angDiff_deg"] < MAX_TANG_DEG):
                    failures.append(f"poselib-test --stereoRef frame "
                                    f"{f['frame']}: {f['R_diff_deg']} / "
                                    f"{f['t_angDiff_deg']} deg")
            rec["nomatch_poselib_test"] = {}
            for name, extra in NOMATCH_RUNS:
                args = ["--sequ_path", str(fs_dir), "--ovf_ext", "yaml.gz",
                        *extra, "--output_path"]
                _, wall, _, syncs = _cli(torch, nomatch_poselib_test.main,
                                         args + [str(tmp / "nc")],
                                         device=dev)
                _cli(torch, nomatch_poselib_test.main,
                     args + [str(tmp / "np")], device="cpu")
                header, rows = _csv_rows(tmp / "nc" / "results.csv")
                cpu_rows = _csv_rows(tmp / "np" / "results.csv")[1]
                n_rows = len(rows)
                nrec = {"wall_s": wall, "states": [r["state"] for r in rows],
                        # the warm-up frame reads as a frame does
                        "host_syncs_per_frame": syncs / (n_rows + 1),
                        "ms_per_frame": {
                            col: float(np.mean([float(r[col] or 0)
                                                for r in rows]))
                            for col in ("filtering_ms",
                                        "robEstimationAndRef_ms",
                                        "stereoRefine_ms")},
                        "R_diffAll": [float(r["R_diffAll"]) for r in rows],
                        "card_vs_cpu_deg": [
                            (abs(float(a["R_diffAll"])
                                 - float(b["R_diffAll"])),
                             abs(float(a["t_angDiff_deg"])
                                 - float(b["t_angDiff_deg"])))
                            for a, b in zip(rows, cpu_rows)]}
                rec["nomatch_poselib_test"][name] = nrec
                if header != list(nomatch_poselib_test.CSV_COLUMNS):
                    failures.append(f"noMatch {name}: CSV header differs")
                if n_rows != 3 or len(cpu_rows) != n_rows:
                    failures.append(f"noMatch {name}: {n_rows} rows on the "
                                    f"card, {len(cpu_rows)} on the CPU")
                if nrec["states"] != [r["state"] for r in cpu_rows]:
                    failures.append(f"noMatch {name}: states {nrec['states']}"
                                    " on the card, "
                                    f"{[r['state'] for r in cpu_rows]} on the"
                                    " CPU")
                for rd, td in nrec["card_vs_cpu_deg"]:
                    if rd >= POSE_ROT_DEG or td >= POSE_TANG_DEG:
                        failures.append(f"noMatch {name}: card vs CPU "
                                        f"{rd} / {td} deg")
                if max(nrec["R_diffAll"]) >= MAX_ROT_DEG:
                    failures.append(f"noMatch {name}: R_diffAll "
                                    f"{nrec['R_diffAll']}")
        finally:
            common.frame_streams, common.stereo_refine_streams = saved

        # matchinglib-test: the stored matches against get_correspondences
        # on the card for the decoded pair
        mout = tmp / "match"
        lines, wall, launches, syncs = _cli(
            torch, matchinglib_test.main,
            img_args + ["--output_path", str(mout)], device=dev)
        summary = json.loads(lines[-1])
        rec["matchinglib_test"] = {
            "total_matches": summary["total_matches"], "wall_s": wall,
            "launches": launches,
            "host_syncs_per_frame": syncs / APP_FRAMES,
            "ms_per_frame": {k: v / APP_FRAMES
                             for k, v in summary["stage_ms"].items()}}
        det, desc, match = common.matching_configs(
            matchinglib_test.build_parser().parse_args(img_args))
        for i in range(APP_FRAMES):
            imgs = [torch.from_numpy(tio.load_image_gray(
                d / f"{side}_{i:04d}.png")).to(dev)
                for side in ("left", "right")]
            corr = pipeline.get_correspondences(*imgs, det, desc, match)
            m = corr.mask.cpu().numpy()
            stored = np.load(mout / f"matches_{i:04d}.npz")
            for name in ("pts1", "pts2", "distance"):
                want = getattr(corr, name).cpu().numpy()[m]
                if not np.array_equal(stored[name], want):
                    failures.append(f"matchinglib-test pair {i}: {name} "
                                    "differs from get_correspondences")
            if not (mout / f"matches_{i:04d}.png").exists():
                failures.append(f"matchinglib-test: matches_{i:04d}.png "
                                "missing")
    for cli in ("poselib_test", "poselib_test_stereoRef", "matchinglib_test"):
        got = rec[cli]["launches"]
        if got["fast_nms"] != 2 * APP_FRAMES or got["knn2"] != 2 * APP_FRAMES:
            failures.append(f"{cli}: launches {got}, expected K1 and K2a "
                            f"{2 * APP_FRAMES} each")
    rec["launches_per_frame"] = {
        cli: {k: v / APP_FRAMES for k, v in rec[cli]["launches"].items()}
        for cli in ("poselib_test", "poselib_test_stereoRef",
                    "matchinglib_test")}
    rec["phase_s"] = time.perf_counter() - t_phase
    return rec, failures


# ---------------------------------------------------------------------------
# phase 9: the rest of the front end
# ---------------------------------------------------------------------------

FRONTEND_TIMED_RUNS = 3
FRONTEND_LEVELS, FRONTEND_SCALE = 4, 1.25
FRONTEND_DESCRIPTORS = ("BRISK", "FREAK", "RIFF", "BOLD", "LATCH", "BGM",
                        "BINBOOST_64", "BINBOOST_128", "BINBOOST_256",
                        "LBGM", "VGG_120", "VGG_80", "VGG_64", "VGG_48",
                        "DAISY")
# descriptor rows also run on the CPU path: one of each module
# (descriptors_ext, descriptors_learned) and each K2a width (16, 2, 4;
# the detector rows give 8 with ORB, AKAZE 16 with MLDB)
FRONTEND_CPU_DESCRIPTORS = ("BRISK", "BINBOOST_64", "BINBOOST_128")
FRONTEND_AGREE = 0.99
FRONTEND_BATCH_ROWS = ("AKAZE/AKAZE", "FAST/BOLD")
FRONTEND_PROFILED = ("KAZE/KAZE", "FAST/BRISK")


def frontend_rows(cfg):
    """Phase 9's rows: (name, DetectorConfig, DescriptorConfig). The
    detector rows describe with ORB (KAZE and AKAZE with their own
    descriptors), the descriptor rows detect with FAST t = 12; 2048 slots,
    pyramids of 4 levels at 1.25."""
    fast = dict(kind="FAST", max_keypoints=2048, fast_threshold=12.0)
    rows = [(f"{k}/ORB", dict(fast, kind=k), "ORB")
            for k in ("HARRIS", "GFTT", "STAR", "MSD", "MSER")]
    rows += [(f"{k} pyramid/ORB", dict(fast, kind=k,
                                       pyramid_levels=FRONTEND_LEVELS,
                                       pyramid_scale=FRONTEND_SCALE), "ORB")
             for k in ("ORB", "BRISK")]
    rows += [(f"{k}/{k}", dict(fast, kind=k), k) for k in ("KAZE", "AKAZE")]
    rows += [(f"FAST/{d}", fast, d) for d in FRONTEND_DESCRIPTORS]
    return [(name, cfg.DetectorConfig(**d), cfg.DescriptorConfig(kind=e))
            for name, d, e in rows]


def frontend_expected(features, det, desc, pairs=1):
    """Kernel launches of `pairs` pairs through ``run`` (pairs=1) or one
    ``run_batch`` of them: K1 once per image (the single-scale FAST rows
    once per stack in a batch), once per level and image for a pyramid,
    never for the other detectors; K2a twice per pair for a binary
    descriptor but BOLD (its own masked matcher), K2b twice for a float
    one."""
    single_fast = det.kind.upper() in ("FAST", "ORB", "BRISK") \
        and det.pyramid_levels == 1
    pyramid = det.kind.upper() in ("ORB", "BRISK") and det.pyramid_levels > 1
    k1 = (2 * pairs * det.pyramid_levels if pyramid
          else (1 if pairs > 1 else 2) if single_fast else 0)
    binary = features.is_binary_descriptor(desc.kind)
    bold = features.is_bold_descriptor(desc.kind)
    return {"fast_nms": k1,
            "knn2": 2 * pairs if binary and not bold else 0,
            "knn2_l2": 0 if binary else 2 * pairs}


def align_by_position(xy_a, mask_a, xy_b, mask_b, tol=1e-4):
    """For every valid slot of a, the slot of b that holds a keypoint at
    the same position (max-norm distance <= tol), else -1; and the share
    of the keypoints valid on either side found on the other. A keypoint
    on an f32 near tie found on one side only moves every later slot;
    aligned, the rest compare slot for slot."""
    xy_a, xy_b = (np.asarray(x, np.float64) for x in (xy_a, xy_b))
    mask_a, mask_b = np.asarray(mask_a, bool), np.asarray(mask_b, bool)
    d = np.abs(xy_a[:, None, :] - xy_b[None, :, :]).max(-1)
    d[~mask_a] = np.inf
    d[:, ~mask_b] = np.inf
    best = d.argmin(1)
    perm = np.where(d[np.arange(len(best)), best] <= tol, best, -1)
    both = int((perm >= 0).sum())
    union = int(mask_a.sum() + mask_b.sum()) - both
    return perm, both / max(union, 1)


def aligned_agreement(a, b):
    """Correspondences a and b (either device) compared with keypoints
    aligned by position: {"keypoints": the smaller of the two images'
    aligned shares, "matches": on the aligned query slots, the share with
    the same match mask and, where both keep a match, the partner within
    1e-4 px}."""
    shares = []
    for ka, kb in ((a.kps1, b.kps1), (a.kps2, b.kps2)):
        perm, share = align_by_position(ka.xy.cpu(), ka.mask.cpu(),
                                        kb.xy.cpu(), kb.mask.cpu())
        shares.append(share)
        if ka is a.kps1:
            perm1 = perm
    rows = np.nonzero(perm1 >= 0)[0]
    cols = perm1[rows]
    ma, mb = a.mask.cpu().numpy()[rows], b.mask.cpu().numpy()[cols]
    close = np.abs(a.pts2.cpu().numpy()[rows]
                   - b.pts2.cpu().numpy()[cols]).max(1) <= 1e-4
    agree = (ma == mb) & (~ma | close)
    return {"keypoints": min(shares),
            "matches": float(agree.mean()) if len(agree) else 0.0}


# K2b's depths on phase 9's float rows: DAISY, VGG_120, VGG_80, VGG_48
# (LBGM's and VGG_64's 64 and RIFF's 128 are phase 3b's)
FRONTEND_L2_DEPTHS = (200, 120, 80, 48)
# K2a's descriptor widths on phase 9's binary rows, in words
FRONTEND_WIDTHS = (2, 4, 16)


def frontend_kernel_checks(torch, knn2, features, cfg, det, i1, i2, seed):
    """Phase 9's kernel checks: K2a bit-exact against its plain version at
    2048 x 2048 on the scene's 512-bit ring (BRISK) descriptors, xy_mode 0,
    1 and 2 (``knn2_inputs``), at ``KNN2_RAGGED`` x 2, 4 and 16 words, on
    the extreme pairs of the 512-bit key (``knn2_extreme_cases``), and at
    17 words on 64 x 64 random words; K2b at ``KNN2_L2_RAGGED`` x
    FRONTEND_L2_DEPTHS; K1 against its zero-padded plain version
    (``check_fast_nms``) at every pixel of each pyramid level of the
    scene, radius 0 and 3. Returns (record with K2a's 16-word times, the
    cases at 2048 x 2048 by xy_mode)."""
    rng = np.random.default_rng(seed + 5)
    dev = i1.device
    ring = cfg.DescriptorConfig(kind="BRISK")
    kp1 = features.detect_keypoints(i1, det)
    kp2 = features.detect_keypoints(i2, det)
    bands = features.detector_bands(det)
    r1, _ = features.compute_descriptors(i1, kp1, ring, bands)
    r2, _ = features.compute_descriptors(i2, kp2, ring, bands)
    if r1.shape != (det.max_keypoints, 16):
        raise AssertionError(f"ring descriptors {tuple(r1.shape)}")
    cases = knn2_inputs(torch, rng, r1, r2, kp1.xy, kp2.xy, dev)
    rec = {"max_abs_err": check_knn2(torch, knn2, cases)}
    for width in FRONTEND_WIDTHS:
        check_knn2_ragged(torch, knn2, knn2_ragged_cases(
            torch, np.random.default_rng(seed + 6 + width), dev, width))
    check_knn2_extreme(torch, knn2, knn2_extreme_cases(torch, dev))
    # 17 words: the runtime-width kernel, bit-exact (phase 12 holds it at
    # every shape)
    wide = torch.from_numpy(rng.integers(-2**31, 2**31, (2, 64, 17))
                            .astype(np.int32)).to(dev)
    ones = torch.ones(64, dtype=torch.bool, device=dev)
    for name, g, w in zip(("d_best", "d_second", "idx"),
                          knn2.knn2(wide[0], wide[1], ones),
                          knn2.knn2_plain(wide[0], wide[1], ones)):
        if not torch.equal(g, w):
            raise AssertionError(f"knn2 17 words: {name} differs from the "
                                 "plain version")
    rec["k2b_max_abs_err"] = check_knn2_l2_ragged(
        torch, knn2, knn2_l2_ragged_cases(
            torch, np.random.default_rng(seed + 7), dev,
            depths=FRONTEND_L2_DEPTHS))
    # K1 at every pixel of each pyramid level of the scene (ragged shapes
    # such as 410 x 1114), at ORB's radius 0 and BRISK's 3
    from matchinglib_poselib_torch.ops import scale_space
    from matchinglib_poselib_torch.ops.kernels import fast_nms

    H, W = i1.shape
    rec["k1_levels"] = []
    for lv in range(1, FRONTEND_LEVELS):
        s = FRONTEND_SCALE**lv
        level = scale_space.resize_linear(
            i1, max(32, int(round(H / s))), max(32, int(round(W / s))))
        for radius in (0, 3):
            err, ties = check_fast_nms(
                torch, fast_nms, level[None].contiguous(),
                det.fast_threshold / 255.0, radius, min_corners=100)
            if ties:
                raise AssertionError(f"fast_nms level {lv} r={radius}: "
                                     f"{ties} tie mismatches, expected 0")
            rec["k1_levels"].append([list(level.shape), radius, err])
    for m in (0, 1):
        k = functools.partial(knn2.knn2, *cases[m], xy_mode=m)
        p = functools.partial(knn2.knn2_plain, *cases[m], xy_mode=m)
        sfx = "" if m == 0 else "_guided"
        rec["ms" + sfx] = _cuda_ms(torch, k)
        rec["plain_ms" + sfx] = _cuda_ms(torch, p)
        rec["device_ms" + sfx] = _device_ms(torch, k)
        rec["plain_device_ms" + sfx] = _device_ms(torch, p)
    rec["shape"] = [r1.shape[0], r2.shape[0], 32 * r1.shape[1]]
    return rec, cases


def frontend_row(torch, kernels, pipeline, robust, name, det, desc, match,
                 pose_cfg, imgs, Kt, dist, truth, seed, timed_runs,
                 cpu_check, profiled):
    """One row of phase 9 on the device of `imgs`: counters from 0, one
    (warm) run with seeded explicit streams, counters read back against
    `frontend_expected`, the pose error against `truth`; `timed_runs`
    timed runs (ms, stage split); with `cpu_check` the port's CPU path on
    the same pair (``aligned_agreement``), with `profiled` one profiled
    step. Returns (record, failures)."""
    from matchinglib_poselib_torch.ops import features

    (img1, img2), (i1, i2) = imgs
    streams = pose_streams(torch, robust, pose_cfg, seed)
    pipe = pipeline.StereoPipeline(det, desc, match, pose_cfg,
                                   device=i1.device)

    def run():
        return pipe.run(i1, i2, Kt, Kt, dist, dist, **streams)

    # the plain FAST score must not run on the card's path (the pyramid
    # levels go through K1): count its calls during the warm run
    plain_calls = []
    plain_score = features.fast_score

    def counted(*a, **kw):
        plain_calls.append(1)
        return plain_score(*a, **kw)

    kernels.reset_launch_counts()
    features.fast_score = counted
    try:
        t0 = time.perf_counter()
        corr, pose = run()
        _sync(torch, i1)
        warm_s = time.perf_counter() - t0
    finally:
        features.fast_score = plain_score
    launches = kernels.launch_counts()
    expected = frontend_expected(features, det, desc)
    failures = [f"{name}: {k} launched {launches[k]} times (expected {v})"
                for k, v in expected.items()
                if i1.is_cuda and launches[k] != v]
    if i1.is_cuda and plain_calls:
        failures.append(f"{name}: the plain fast_score ran "
                        f"{len(plain_calls)} times on the card")
    rot = _rot_deg(truth[0], pose.R.cpu().numpy())
    tdir = _dir_deg(truth[1], pose.t.cpu().numpy())
    rec = {"row": name, "launches": launches, "n_corr": int(corr.n),
           "n_inliers": int(pose.n_inliers), "rot_err_deg": rot,
           "t_err_deg": tdir, "warm_s": warm_s}
    if not bool(torch.isfinite(pose.R).all() and torch.isfinite(pose.t).all()
                and torch.isfinite(corr.pts2).all()):
        failures.append(f"{name}: non-finite pose or correspondences")
    # every row's CPU path meets the bars (chip_probes/frontend_rehearsal.py)
    if not (rot < MAX_ROT_DEG and tdir < MAX_TANG_DEG):
        failures.append(f"{name}: pose off the planted pose: rot {rot:.4f} "
                        f"deg, t {tdir:.4f} deg")
    if timed_runs:
        pipe.timer.reset()
        ms = []
        for _ in range(timed_runs):
            _sync(torch, i1)
            t0 = time.perf_counter()
            run()
            _sync(torch, i1)
            ms.append((time.perf_counter() - t0) * 1e3)
        rec.update({"runs": timed_runs, "ms_mean": float(np.mean(ms)),
                    "ms_median": float(np.median(ms)),
                    "stages_ms": {k: v / timed_runs
                                  for k, v in pipe.timer.times_ms.items()}})
    if profiled:
        busy_ms, ops, wall_ms = _profile_step(torch, run)
        rec["profiled_run"] = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
                               "device_ops": ops}
    if cpu_check:
        t0 = time.perf_counter()
        cpu = pipeline.get_correspondences(
            torch.from_numpy(img1), torch.from_numpy(img2), det, desc, match)
        rec["cpu_agree"] = aligned_agreement(corr, cpu)
        rec["cpu_check_s"] = time.perf_counter() - t0
        if min(rec["cpu_agree"].values()) < FRONTEND_AGREE:
            failures.append(f"{name}: card vs CPU {rec['cpu_agree']}")
    return rec, failures


def _sync(torch, x):
    if x.is_cuda:
        torch.cuda.synchronize()


def frontend_batch(torch, kernels, pipeline, robust, name, det, desc, match,
                   pose_cfg, dev, seed):
    """``run_batch`` of frames 1-2 of the sequence at a phase-9 row with
    seeded explicit streams: counters from 0, one batch, counters read
    back against `frontend_expected`; each pair equal to ``run`` of that
    pair (``batch_vs_run``). Returns (record, failures)."""
    from matchinglib_poselib_torch.ops import features

    pairs, K, _, _ = _sequence(seed)
    pairs = pairs[:2]
    imgs1 = torch.from_numpy(np.stack([a for a, _ in pairs])).to(dev)
    imgs2 = torch.from_numpy(np.stack([b for _, b in pairs])).to(dev)
    Kt = torch.from_numpy(K).to(dev)
    dist = torch.zeros(5, device=dev)
    U, D = batch_streams(torch, robust, pose_cfg, seed + 70, 2)
    U, D = U.to(dev), D.to(dev)
    pipe = pipeline.StereoPipeline(det, desc, match, pose_cfg, device=dev)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    corr, pose = pipe.run_batch(imgs1, imgs2, Kt, Kt, dist, dist,
                                uniforms=U, degen_uniforms=D)
    _sync(torch, imgs1)
    batch_ms = (time.perf_counter() - t0) * 1e3
    launches = kernels.launch_counts()
    expected = frontend_expected(features, det, desc, pairs=2)
    failures = [f"batch {name}: {k} launched {launches[k]} times (expected "
                f"{v})" for k, v in expected.items()
                if dev.type == "cuda" and launches[k] != v]
    singles = [pipe.run(imgs1[i], imgs2[i], Kt, Kt, dist, dist,
                        uniforms=U[i], degen_uniforms=D[i]) for i in range(2)]
    rows, fails = batch_vs_run(torch, corr, pose, singles)
    failures += [f"batch {name}: {f}" for f in fails]
    return {"launches": launches, "batch_ms": batch_ms,
            "batch_vs_run": rows}, failures


def frontend_cli(torch, kernels, pipeline, dev, seed):
    """``matchinglib-test --f_detect AKAZE --d_extr AKAZE`` on phase 8's
    files (frames 1-APP_FRAMES of the sequence as PNGs): each stored
    ``matches_XXXX.npz`` equal to ``get_correspondences`` of the decoded
    pair on `dev`; K1 never, K2a twice per frame. Returns (record,
    failures)."""
    import pathlib
    import tempfile

    from matchinglib_poselib_torch.apps import common, matchinglib_test
    from matchinglib_poselib_torch.utils import io as tio

    pairs, K, R, t = render_sequence(seed, APP_FRAMES)
    failures = []
    with tempfile.TemporaryDirectory() as tmp:
        d = pathlib.Path(tmp) / "imgs"
        write_stereo_dir(d, pairs, K, R, t)
        argv = ["--img_path", str(d), "--f_detect", "AKAZE", "--d_extr",
                "AKAZE"]
        out = pathlib.Path(tmp) / "match"
        lines, wall, launches, syncs = _cli(
            torch, matchinglib_test.main, argv + ["--output_path", str(out)],
            device=dev)
        summary = json.loads(lines[-1])
        det, desc, match = common.matching_configs(
            matchinglib_test.build_parser().parse_args(argv))
        for i in range(APP_FRAMES):
            imgs = [torch.from_numpy(tio.load_image_gray(
                d / f"{side}_{i:04d}.png")).to(dev)
                for side in ("left", "right")]
            corr = pipeline.get_correspondences(*imgs, det, desc, match)
            m = corr.mask.cpu().numpy()
            stored = np.load(out / f"matches_{i:04d}.npz")
            for field in ("pts1", "pts2", "distance"):
                if not np.array_equal(stored[field],
                                      getattr(corr, field).cpu().numpy()[m]):
                    failures.append(f"matchinglib-test AKAZE pair {i}: "
                                    f"{field} differs from "
                                    "get_correspondences")
    if dev.type == "cuda" and (launches["fast_nms"] != 0
                               or launches["knn2"] != 2 * APP_FRAMES):
        failures.append(f"matchinglib-test AKAZE: launches {launches}, "
                        f"expected K1 0 and K2a {2 * APP_FRAMES}")
    return {"total_matches": summary["total_matches"], "wall_s": wall,
            "launches": launches, "host_syncs_per_frame": syncs / APP_FRAMES,
            "ms_per_frame": {k: v / APP_FRAMES
                             for k, v in summary["stage_ms"].items()}}, \
        failures


def frontend_phase(torch, cfg, match, pose_cfg, imgs, Kt, dist, truth, dev,
                   seed, smi, timed_runs=FRONTEND_TIMED_RUNS,
                   cpu_checks=True):
    """Phase 9: every row of ``frontend_rows`` through ``StereoPipeline.run``
    on the scene (``frontend_row``; the CPU path for the detector rows and
    FRONTEND_CPU_DESCRIPTORS), ``run_batch`` at FRONTEND_BATCH_ROWS
    (``frontend_batch``) and ``matchinglib-test`` at AKAZE/AKAZE
    (``frontend_cli``). Returns ({row: record}, extra records,
    failures)."""
    from matchinglib_poselib_torch.models import pipeline
    from matchinglib_poselib_torch.ops import kernels, robust

    t_phase = time.perf_counter()
    rows, failures = {}, []
    for r_i, (name, det, desc) in enumerate(frontend_rows(cfg)):
        cpu_check = cpu_checks and (
            desc.kind in FRONTEND_CPU_DESCRIPTORS
            or not name.startswith("FAST/"))
        rec, fails = frontend_row(
            torch, kernels, pipeline, robust, name, det, desc, match,
            pose_cfg, imgs, Kt, dist, truth, seed + 300 + r_i, timed_runs,
            cpu_check, name in FRONTEND_PROFILED)
        rec["card"] = smi
        rows[name] = rec
        failures += fails
    extra = {"card": smi, "batch": {}}
    by_name = {name: (det, desc) for name, det, desc in frontend_rows(cfg)}
    for name in FRONTEND_BATCH_ROWS:
        extra["batch"][name], fails = frontend_batch(
            torch, kernels, pipeline, robust, name, *by_name[name], match,
            pose_cfg, dev, seed)
        failures += fails
    extra["matchinglib_test_akaze"], fails = frontend_cli(
        torch, kernels, pipeline, dev, seed)
    failures += fails
    extra["phase_s"] = time.perf_counter() - t_phase
    return rows, extra, failures


# ---------------------------------------------------------------------------
# phase 10: the library layer
# ---------------------------------------------------------------------------

# A2: the rotation models' bar (max entry)
LIB_MODEL_ATOL = 1e-4
LIB_AGREE = 0.99
LIB_TIMED_RUNS = 3
LIB_ROT_PLANTED = 2048  # correspondences of the planted pure rotation
# A3: the planted LK shift (x, y) in px and the JAX test's bars
LK_SHIFT = (6.0, -4.0)
LK_MEDIAN_ERR_PX = 0.25
LK_STATUS_SHARE = 0.8
FLOW_ATOL_PX = 0.02
LKOF_RADIUS = 10.0
ALKOF_MAX_HAMM = 60.0
# LKOF's near ties in squared px: a slot counts only where the plain
# version's gap d_second - d_best and |d_best - r^2| both exceed this
NEAR_TIE_PX2 = 1.0
# K2b at D = 2 and 3 (the pixel coordinates of LKOF; a depth that is not
# a multiple of 4)
LIB_L2_DEPTHS = (2, 3)
F32_EPS = 2.0 ** -23
# A4: the node's parameters (the flagship front end and hypotheses)
NODE_PARAMS = {"f_detect_th": "12", "batch_hypotheses": "96",
               "max_batches": "12"}
NODE_STEREO = {"stereoRef": "1", "evStepStereoStable": "2"}


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _lib_timed(torch, dev, fn, runs=LIB_TIMED_RUNS):
    """A warm call of `fn`, then `runs` calls: (the warm call's output,
    {ms per call on a host clock that ends in a synchronize, host syncs
    per call, device ops and busy ms of one profiled call (the card
    only)})."""
    from matchinglib_poselib_torch.utils.profiling import HostSyncs

    out = fn()
    _sync(torch, dev)
    s0 = HostSyncs.count
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    _sync(torch, dev)
    rec = {"ms": (time.perf_counter() - t0) * 1e3 / runs,
           "host_syncs": (HostSyncs.count - s0) / runs,
           "device_ops": None, "device_busy_ms": None}
    if dev.type == "cuda":
        rec["device_busy_ms"], rec["device_ops"], _ = _profile_step(torch,
                                                                    fn)
    return out, rec


def _unit_sign(M):
    M = np.asarray(M, np.float64)
    M = M / np.linalg.norm(M)
    return M * np.sign(M.flat[np.argmax(np.abs(M))])


def planted_rotation(seed, n=LIB_ROT_PLANTED, outliers=0.2):
    """A pure rotation (5 deg) seen by the scene's camera: normalized
    correspondences (n, 2) with 0.1 px of noise (an eighth of the 0.8 px
    threshold, as tests/test_pose_families.py keeps its noise a tenth of
    its threshold) and `outliers` of them uniform, as float32 numpy."""
    rng = np.random.default_rng(seed)
    f = K_FULL[0, 0]
    X = np.stack([rng.uniform(-6, 6, n), rng.uniform(-2, 2, n),
                  rng.uniform(6, 40, n)], axis=1)
    R = _rot((0.1, 1.0, 0.2), 5.0)
    X2 = X @ R.T
    x1 = X[:, :2] / X[:, 2:3] + rng.normal(0, 0.1 / f, (n, 2))
    x2 = X2[:, :2] / X2[:, 2:3] + rng.normal(0, 0.1 / f, (n, 2))
    k = int(outliers * n)
    x2[:k] = rng.uniform(-0.6, 0.6, (k, 2))
    return x1.astype(np.float32), x2.astype(np.float32)


def _unit_models(M):
    """(..., 3, 3) models -> (-1, 9) float64 rows of unit norm, sign fixed
    by the largest entry."""
    M = np.asarray(M, np.float64).reshape(-1, 9)
    M = M / np.maximum(np.linalg.norm(M, axis=1, keepdims=True), 1e-300)
    i = np.argmax(np.abs(M), axis=1)
    return M * np.sign(M[np.arange(len(M)), i])[:, None]


def _recording(orig, log):
    """A stand-in for the family constructor `orig` whose family appends
    each batch's (samples 1, samples 2, models, validity) to `log`, on
    the host."""

    def family():
        fam = orig()

        def solve(s1, s2):
            M, v = fam.solve(s1, s2)
            log.append(tuple(a.cpu() for a in (s1, s2, M, v)))
            return M, v

        return fam._replace(solve=solve)

    return family


def _sample_residuals(torch, s1, s2, M, v):
    """Per valid model: the largest |h2^T F h1| / (|h1| |h2|) over its
    sample's points, F of unit norm (float64)."""
    h1, h2 = (torch.cat([s, torch.ones_like(s[..., :1])], dim=-1).double()
              for s in (s1, s2))
    U = torch.from_numpy(_unit_models(M)).reshape(M.shape)
    r = torch.einsum("sni,smij,snj->smn", h2, U, h1).abs() / (
        h1.norm(dim=-1) * h2.norm(dim=-1))[:, None]
    return r.amax(dim=-1)[v].numpy()


def check_f_row(torch, robust, name, logs, res, cpu, inp_cpu):
    """A robust F row's card result against the CPU's: the same samples in
    every batch both ran; the card's inlier mask equal to the CPU's
    rescoring of the card's model on >= 99% of the slots; the card's
    inliers >= 99% of the CPU's (``library_estimators`` also holds the
    masks, as for the other estimators). `logs`: the card's and the CPU's
    batches (``_recording``). The hypotheses themselves are reported, not
    held: the minimal solves take the eigenvector of A^T A, whose forward
    error on these ill-conditioned samples is the eigensolver's (the
    card's batched eigh runs in float64 since cuSOLVER's float32 one lay
    ~40x farther from the float64 solve than LAPACK's here,
    ``chip_probes/f_degenerate_samples.py``): each hypothesis's distance
    from the float64 solve of its sample (unit norm, up to sign; 7pt: the
    nearest of the sample's float64 roots) and its residual on its
    sample, percentiles 50 / 90, on both devices. For the 8pt row also,
    reported: the batched essential 8pt (``solvers.solve_8pt``) on the
    same samples, card vs CPU and each against float64. Returns (record,
    failures)."""
    fails = []
    log_c, log_p = logs
    nb = min(len(log_c), len(log_p))
    same = all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
               for a, b in zip(log_c[:nb], log_p[:nb]))
    fam = (robust.fundamental_8pt_family() if name.endswith("8pt")
           else robust.fundamental_7pt_family())
    s1, s2 = (torch.cat([b[i] for b in log_p[:nb]]) for i in (0, 1))
    M64, v64 = fam.solve(s1.double(), s2.double())
    (Mc, vc), (Mp, vp) = ((torch.cat([b[2] for b in lg[:nb]]),
                           torch.cat([b[3] for b in lg[:nb]]))
                          for lg in (log_c, log_p))
    S, m = vp.shape
    ref, v64 = _unit_models(M64).reshape(S, m, 9), v64.numpy()

    def dist(M, v):
        """Per valid model: the distance to the nearest valid float64
        model of its sample (7pt: a sample's roots come in any order)."""
        U = _unit_models(M).reshape(S, m, 9)
        d = np.minimum(
            np.linalg.norm(U[:, :, None] - ref[:, None], axis=-1),
            np.linalg.norm(U[:, :, None] + ref[:, None], axis=-1))
        d = np.where(v64[:, None, :], d, np.inf).min(axis=-1)
        return d[v.numpy() & v64.any(axis=1)[:, None]]

    def pct(x):
        return [float(np.percentile(x, q)) for q in (50, 90)]

    x1, x2, mask, _ = inp_cpu
    err = robust._sampson_family_error(res.model.cpu()[None], x1, x2)[0]
    rescored = (err < res.threshold.cpu()) & mask.to(torch.bool)
    rec = {"batches": [len(log_c), len(log_p)], "same_samples": same,
           "hypotheses": [int(vc.sum()), int(vp.sum())],
           "card_vs_f64": pct(dist(Mc, vc)), "cpu_vs_f64": pct(dist(Mp, vp)),
           "residual_card": pct(_sample_residuals(torch, s1, s2, Mc, vc)),
           "residual_cpu": pct(_sample_residuals(torch, s1, s2, Mp, vp)),
           "rescored_mask_agree": float(
               (rescored == res.inlier_mask.cpu()).float().mean())}
    if name.endswith("8pt"):
        from matchinglib_poselib_torch.ops import solvers

        dev = res.model.device
        units = {k: _unit_models(solvers.solve_8pt(*(
            x.to(dev) if k == "card" else x.double() if k == "f64" else x
            for x in (s1, s2)))[0].cpu().numpy())
            for k in ("card", "cpu", "f64")}

        def apart(a, b):
            return pct(np.minimum(np.linalg.norm(a - b, axis=1),
                                  np.linalg.norm(a + b, axis=1)))
        rec["essential_8pt"] = {
            "card_vs_cpu": apart(units["card"], units["cpu"]),
            "card_vs_f64": apart(units["card"], units["f64"]),
            "cpu_vs_f64": apart(units["cpu"], units["f64"])}
    if not same:
        fails.append("the card and the CPU drew other samples")
    if rec["rescored_mask_agree"] < LIB_AGREE:
        fails.append(f"the card's mask agrees with its model rescored on "
                     f"the CPU on {rec['rescored_mask_agree']}")
    if int(res.n_inliers) < LIB_AGREE * int(cpu.n_inliers):
        fails.append(f"{int(res.n_inliers)} inliers on the card, "
                     f"{int(cpu.n_inliers)} on the CPU")
    return rec, fails


def library_estimators(torch, dev, corr, K, robust_cfg, seed):
    """A2 of phase 10: the four library estimators (fundamental 7pt and
    8pt, rotation-only, no-motion, QDEGSAC) on the flagship's card
    correspondences, normalized, and on a planted pure rotation, with
    seeded explicit streams, each on `dev` and on the CPU. The F rows are
    held sample by sample (``check_f_row``: their inliers >= 99% of the
    CPU's) and, as every row, by their masks (>= 99%, no-motion's equal);
    the rotation models (1e-4), QDEGSAC's decision and its E's pose.
    Returns ({row: record}, failures)."""
    from matchinglib_poselib_torch.ops import geometry as geo, robust

    failures = []
    Kt = torch.from_numpy(K).to(dev)
    f_mean = float(K[0, 0] + K[1, 1]) / 2.0
    th_sq = (robust_cfg.threshold_px / f_mean) ** 2
    rcfg = dataclasses.replace(robust_cfg, check_degeneracy=False)
    nb, B = rcfg.max_batches, rcfg.batch_hypotheses
    rng = np.random.default_rng(seed + 50)

    def u(*shape):
        return torch.from_numpy(rng.random(shape).astype(np.float32))

    streams = {"fundamental_7pt": u(nb, B, 7), "fundamental_8pt":
               u(nb, B, 8), "rotation": u(nb, B, 2), "nomotion": None,
               "qdegsac": tuple(u(*s) for s in
                                robust.qdegsac_sample_shapes(rcfg))}

    def call(name, inp, s):
        x1, x2, mask, quality = inp
        if name == "qdegsac":
            return robust.estimate_essential_qdegsac(
                x1, x2, mask, quality, rcfg, th_sq, uniforms=s)
        if name == "nomotion":
            return robust.estimate_nomotion_robust(x1, x2, mask, quality,
                                                   rcfg, th_sq)
        if name == "rotation":
            return robust.estimate_rotation_robust(
                x1, x2, mask, quality, rcfg, th_sq, uniforms=s)
        return robust.estimate_fundamental_robust(
            x1, x2, mask, quality, rcfg, th_sq,
            use_8pt=name.endswith("8pt"), uniforms=s)

    def to(x, device):
        if x is None:
            return None
        if isinstance(x, tuple):
            return tuple(to(a, device) for a in x)
        return x.to(device)

    flag = (geo.img_to_cam(corr.pts1, Kt), geo.img_to_cam(corr.pts2, Kt),
            corr.mask, corr.quality)
    p1, p2 = planted_rotation(seed + 51)
    planted = tuple(torch.from_numpy(a).to(dev) for a in (p1, p2)) + (
        torch.ones(len(p1), dtype=torch.bool, device=dev), None)
    recs = {}
    for set_name, inp in (("flagship", flag), ("pure_rotation", planted)):
        inp_cpu = to(inp, "cpu")
        for name, s in streams.items():
            row = f"{name} / {set_name}"
            rec = {}
            if set_name == "flagship":
                _, rec = _lib_timed(torch, dev, lambda: call(
                    name, inp, to(s, dev)))
            if name.startswith("fundamental"):
                fam_name = name + "_family"
                logs = ([], [])
                orig = getattr(robust, fam_name)
                try:
                    setattr(robust, fam_name, _recording(orig, logs[0]))
                    res = call(name, inp, to(s, dev))
                    setattr(robust, fam_name, _recording(orig, logs[1]))
                    cpu = call(name, inp_cpu, s)
                finally:
                    setattr(robust, fam_name, orig)
                rec["samples"], fails = check_f_row(torch, robust, name,
                                                    logs, res, cpu, inp_cpu)
                failures.extend(f"{row}: {f}" for f in fails)
            else:
                res, cpu = call(name, inp, to(s, dev)), call(name, inp_cpu, s)
            q_card, q_cpu = (r.result if name == "qdegsac" else r
                             for r in (res, cpu))
            m_c = q_card.inlier_mask.cpu().numpy()
            m_p = q_cpu.inlier_mask.cpu().numpy()
            rec["n_inliers"] = int(q_card.n_inliers)
            rec["n_inliers_cpu"] = int(q_cpu.n_inliers)
            rec["mask_agree"] = float((m_c == m_p).mean())
            if name == "nomotion":
                if not np.array_equal(m_c, m_p):
                    failures.append(f"{row}: masks not equal")
            elif rec["mask_agree"] < LIB_AGREE:
                failures.append(f"{row}: inlier masks agree on "
                                f"{rec['mask_agree']}")
            if name == "qdegsac":
                rec["is_degenerate"] = bool(res.is_degenerate)
                rec["rot_fraction"] = float(res.rot_fraction)
                rec["rot_fraction_cpu"] = float(cpu.rot_fraction)
                rec["F_mask_agree"] = float((
                    res.F_result.inlier_mask.cpu()
                    == cpu.F_result.inlier_mask).float().mean())
                if rec["is_degenerate"] != bool(cpu.is_degenerate):
                    failures.append(f"{row}: is_degenerate "
                                    f"{rec['is_degenerate']} on the card, "
                                    f"{bool(cpu.is_degenerate)} on the CPU")
                if set_name == "pure_rotation" and not rec["is_degenerate"]:
                    failures.append(f"{row}: the planted pure rotation is "
                                    f"not degenerate ({rec['rot_fraction']})")
                if not rec["is_degenerate"]:
                    # E: the poses it gives, as phase 4d holds them
                    x1c, x2c = inp_cpu[:2]
                    Rc, tc, *_ = geo.recover_pose(
                        q_card.model.cpu(), x1c, x2c,
                        q_card.inlier_mask.cpu().float())
                    Rp, tp, *_ = geo.recover_pose(q_cpu.model, x1c, x2c,
                                                  q_cpu.inlier_mask.float())
                    rec["card_vs_cpu_deg"] = [_rot_deg(Rc, Rp),
                                              _dir_deg(tc, tp)]
                    if not (rec["card_vs_cpu_deg"][0] < POSE_ROT_DEG
                            and rec["card_vs_cpu_deg"][1] < POSE_TANG_DEG):
                        failures.append(f"{row}: E's pose card vs CPU "
                                        f"{rec['card_vs_cpu_deg']} deg")
            if name in ("rotation", "fundamental_7pt", "fundamental_8pt"):
                rec["model_max_abs_diff"] = float(np.abs(
                    _unit_models(res.model.cpu().numpy())
                    - _unit_models(cpu.model.numpy())).max())
            if name == "rotation" and rec["model_max_abs_diff"] \
                    > LIB_MODEL_ATOL:
                failures.append(f"{row}: R {rec['model_max_abs_diff']} off "
                                "the CPU's")
            recs[row] = rec
    return recs, failures


def _flow_card_vs_cpu(fl, fl_cpu):
    d = (fl.pts.cpu() - fl_cpu.pts).abs().amax(dim=1).numpy()
    st = (fl.status.cpu() == fl_cpu.status).float().mean().item()
    return float((d <= FLOW_ATOL_PX).mean()), st, float(d.max())


def _near_ties(d_best, d_second, r2=None):
    """Slots where the plain version's top-2 gap, or (with a radius) the
    best distance's distance from r^2, is within NEAR_TIE_PX2."""
    tie = (d_second - d_best) <= NEAR_TIE_PX2
    if r2 is not None:
        tie = tie | ((d_best - r2).abs() <= NEAR_TIE_PX2)
    return tie


def library_flow(torch, dev, seed, det, desc):
    """A3 of phase 10: LK flow on the left image of frame 1 against the
    same image shifted by LK_SHIFT (the JAX test's bar), then LKOF and
    ALKOF between the left images of frames 1 and 2, each on `dev` and on
    the CPU, and K2b against its plain version at D = 2 on the LK
    predictions and the next keypoints. Returns (record, failures)."""
    from scipy.ndimage import shift as nd_shift

    from matchinglib_poselib_torch.ops import features, kernels, optflow
    from matchinglib_poselib_torch.ops.kernels import knn2

    failures = []
    rec = {}
    pairs = _sequence(seed)[0]
    left1, left2 = pairs[0][0], pairs[1][0]
    planted = nd_shift(left1, (LK_SHIFT[1], LK_SHIFT[0]), order=1,
                       mode="nearest").astype(np.float32)
    imgs = {k: torch.from_numpy(v).to(dev) for k, v in
            (("l1", left1), ("l2", left2), ("shift", planted))}
    bands = features.detector_bands(det)
    kp1 = features.detect_keypoints(imgs["l1"], det)
    kp2 = features.detect_keypoints(imgs["l2"], det)
    d1, _ = features.compute_descriptors(imgs["l1"], kp1, desc, bands)
    d2, _ = features.compute_descriptors(imgs["l2"], kp2, desc, bands)

    def cpu(*xs):
        return [x.cpu() for x in xs]

    # the planted shift
    fl, rec["lk_flow"] = _lib_timed(torch, dev, lambda: optflow.lk_flow(
        imgs["l1"], imgs["shift"], kp1.xy, kp1.mask))
    fl_cpu = optflow.lk_flow(*cpu(imgs["l1"], imgs["shift"], kp1.xy,
                                  kp1.mask))
    st = fl.status.cpu().numpy()
    valid = kp1.mask.cpu().numpy()
    err = np.abs(fl.pts.cpu().numpy()[st] - (kp1.xy.cpu().numpy()[st]
                                             + np.asarray(LK_SHIFT)))
    rec["lk_flow"].update(
        points=int(valid.sum()), status_share=float(st.sum() / valid.sum()),
        median_err_px=float(np.median(err)))
    rec["lk_flow"]["card_vs_cpu"] = _flow_card_vs_cpu(fl, fl_cpu)
    if not (rec["lk_flow"]["status_share"] >= LK_STATUS_SHARE
            and rec["lk_flow"]["median_err_px"] < LK_MEDIAN_ERR_PX):
        failures.append(f"lk_flow planted shift: status "
                        f"{rec['lk_flow']['status_share']}, median error "
                        f"{rec['lk_flow']['median_err_px']} px")

    # frames 1 -> 2: the flow, LKOF, ALKOF, card vs CPU
    fl = optflow.lk_flow(imgs["l1"], imgs["l2"], kp1.xy, kp1.mask)
    fl_cpu = optflow.lk_flow(*cpu(imgs["l1"], imgs["l2"], kp1.xy, kp1.mask))
    rec["flow_frames_1_2"] = {
        "status_share": float(fl.status.sum() / kp1.mask.sum()),
        "card_vs_cpu": _flow_card_vs_cpu(fl, fl_cpu)}
    for key in ("lk_flow", "flow_frames_1_2"):
        share, st_agree, _ = rec[key]["card_vs_cpu"]
        if share < LIB_AGREE or st_agree < LIB_AGREE:
            failures.append(f"{key}: card vs CPU flow within "
                            f"{FLOW_ATOL_PX} px on {share}, status equal on "
                            f"{st_agree}")
    lkof_args = (kp1.xy, kp2.xy, kp1.mask, kp2.mask, imgs["l1"], imgs["l2"])
    alkof_args = (kp1.xy, kp2.xy, d1, d2, kp1.mask, kp2.mask, imgs["l1"],
                  imgs["l2"])
    for name, fn, args, kw in (
            ("match_lkof", optflow.match_lkof, lkof_args,
             dict(search_radius=LKOF_RADIUS)),
            ("match_alkof", optflow.match_alkof, alkof_args,
             dict(search_radius=LKOF_RADIUS, max_hamm=ALKOF_MAX_HAMM))):
        kernels.reset_launch_counts()
        res = fn(*args, **kw)
        _sync(torch, dev)
        launches = kernels.launch_counts()
        _, r = _lib_timed(torch, dev, lambda: fn(*args, **kw))
        r["launches"] = launches
        res_cpu = fn(*cpu(*args), **kw)
        mc, mp = res.mask.cpu(), res_cpu.mask
        both = mc & mp
        same = res.idx.cpu() == res_cpu.idx
        if name == "match_lkof":
            tie = _near_ties(res_cpu.distance, res_cpu.second_distance,
                             LKOF_RADIUS ** 2)
            r["near_tie_slots"] = int((both & tie).sum())
            both = both & ~tie
        r.update(kept=int(mc.sum()), kept_cpu=int(mp.sum()),
                 mask_agree=float((mc == mp).float().mean()),
                 idx_agree=float(same[both].float().mean()))
        want = {"knn2_l2": 1, "knn2": 0, "fast_nms": 0} \
            if name == "match_lkof" else {"knn2": 1, "knn2_l2": 0,
                                          "fast_nms": 0}
        if dev.type == "cuda" and launches != want:
            failures.append(f"{name}: launches {launches}, expected {want}")
        if r["mask_agree"] < LIB_AGREE or r["idx_agree"] < LIB_AGREE \
                or r["kept"] < MIN_INLIERS:
            failures.append(f"{name}: {r['kept']} kept, masks agree on "
                            f"{r['mask_agree']}, idx on {r['idx_agree']}")
        rec[name] = r

    # K2b at D = 2 on the LK predictions against the next keypoints
    a, b, v2 = fl.pts.contiguous(), kp2.xy.contiguous(), kp2.mask
    got = knn2.knn2_l2(a, b, v2)
    want = knn2.knn2_l2_plain(a, b, v2)
    _sync(torch, dev)
    scale = ((a * a).sum(1) + (b * b).sum(1).max()) * 8 * F32_EPS
    bad = int(((got[0] - want[0]).abs() > scale).sum()
              + ((got[1] - want[1]).abs() > scale).sum())
    tie = _near_ties(want[0], want[1])
    rec["k2b_d2_coords"] = {
        "shape": [a.shape[0], b.shape[0], 2],
        "max_abs_err": float((got[0] - want[0]).abs().max()),
        "near_tie_slots": int(tie.sum()),
        "idx_mismatch_outside_ties": int(((got[2] != want[2]) & ~tie)
                                         .sum())}
    if bad or rec["k2b_d2_coords"]["idx_mismatch_outside_ties"]:
        failures.append(f"knn2_l2 D=2 on LK coordinates: {bad} distances "
                        f"beyond 8 ulps of |a|^2 + |b|^2, "
                        f"{rec['k2b_d2_coords']['idx_mismatch_outside_ties']}"
                        " idx mismatches outside near ties")
    return rec, failures


def library_apps(torch, dev, seed):
    """A4 of phase 10: ``MatchingPoselibNode`` on frames 1-3 of the
    sequence, plain and with stereoRef + evStepStereoStable = 2, each pose
    within the accuracy bars and the CPU's replay of the node from the
    card's correspondences within phase 4d's bars with the same republish
    pattern (seeded streams through ``apps.common``); ``entry()``'s step
    on `dev` under ``utils.profiling.trace``; the example on the frames
    as PNGs. Returns (record, failures)."""
    import pathlib
    import tempfile
    import types

    from matchinglib_poselib_torch import entry
    from matchinglib_poselib_torch.apps import common, ros_interface
    from matchinglib_poselib_torch.examples import match_and_pose
    from matchinglib_poselib_torch.models import pipeline
    from matchinglib_poselib_torch.ops import kernels, robust
    from matchinglib_poselib_torch.utils import profiling
    from matchinglib_poselib_torch.utils.profiling import HostSyncs

    failures = []
    rec = {}
    pairs, K, R_true, t_true = _sequence(seed)
    frames = pairs[:APP_FRAMES]
    get_corr = pipeline.get_correspondences
    saved = common.frame_streams, common.stereo_refine_streams
    common.frame_streams = lambda i, cfg: pose_streams(
        torch, robust, cfg, seed + 300 + i)
    common.stereo_refine_streams = lambda cfg: SeededStreams(
        torch, cfg.pose.robust, seed + 400)
    try:
        for name, extra in (("node", {}), ("node_stereoRef", NODE_STEREO)):
            params = dict(NODE_PARAMS, **extra)
            recorded = []

            def record(*a, **kw):
                c = get_corr(*a, **kw)
                recorded.append(c)
                return c

            def run(device):
                node = ros_interface.MatchingPoselibNode(params,
                                                         device=device)
                node.set_calibration(K, K, np.zeros(5), np.zeros(5))
                msgs, ms = [], []
                for img1, img2 in frames:
                    t0 = time.perf_counter()
                    msgs.append(node.handle_stereo_pair(img1, img2))
                    _sync(torch, node.device)
                    ms.append((time.perf_counter() - t0) * 1e3)
                return msgs, ms

            pipeline.get_correspondences = record
            kernels.reset_launch_counts()
            s0 = HostSyncs.count
            msgs, ms = run(dev)
            r = {"ms_per_frame": ms, "launches": kernels.launch_counts(),
                 "host_syncs_per_frame": (HostSyncs.count - s0) / len(ms)}
            # the CPU node, fed the card's correspondences
            replay = iter(recorded)

            def replayed(*a, **kw):
                c = next(replay)
                return types.SimpleNamespace(
                    pts1=c.pts1.cpu(), pts2=c.pts2.cpu(), mask=c.mask.cpu(),
                    quality=c.quality.cpu())

            pipeline.get_correspondences = replayed
            msgs_cpu, _ = run("cpu")
            pipeline.get_correspondences = get_corr
            pattern = [i > 0 and msgs[i] is msgs[i - 1]
                       for i in range(len(msgs))]
            pattern_cpu = [i > 0 and msgs_cpu[i] is msgs_cpu[i - 1]
                           for i in range(len(msgs))]
            r["republished"] = pattern
            r["err_deg"] = [[_rot_deg(m.R, R_true), _dir_deg(m.t, t_true)]
                            for m in msgs]
            r["card_vs_cpu_deg"] = [[_rot_deg(m.R, c.R), _dir_deg(m.t, c.t)]
                                    for m, c in zip(msgs, msgs_cpu)]
            r["n_inliers"] = [m.n_inliers for m in msgs]
            r["pose_is_stable"] = [m.pose_is_stable for m in msgs]
            if pattern != pattern_cpu:
                failures.append(f"{name}: republished {pattern} on the "
                                f"card, {pattern_cpu} on the CPU")
            for i, ((re, te), (rc, tc)) in enumerate(zip(
                    r["err_deg"], r["card_vs_cpu_deg"])):
                if not (re < MAX_ROT_DEG and te < MAX_TANG_DEG):
                    failures.append(f"{name} frame {i + 1}: {re} / {te} "
                                    "deg against the planted pose")
                if not (rc < POSE_ROT_DEG and tc < POSE_TANG_DEG):
                    failures.append(f"{name} frame {i + 1}: card vs CPU "
                                    f"{rc} / {tc} deg")
            n_eval = len(msgs) - sum(pattern)
            if dev.type == "cuda" and r["launches"] != {
                    "fast_nms": 2 * n_eval, "knn2": 2 * n_eval,
                    "knn2_l2": 0}:
                failures.append(f"{name}: launches {r['launches']} over "
                                f"{n_eval} evaluated frames")
            rec[name] = r
    finally:
        pipeline.get_correspondences = get_corr
        common.frame_streams, common.stereo_refine_streams = saved

    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        # entry()'s step once, under trace()
        fn, args = entry.entry(device=dev)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with profiling.trace(str(tmp / "trace")):
            R, t, n_inl, n_corr = fn(*args)
            _sync(torch, dev)
        traces = [p for p in (tmp / "trace").glob("*.json")
                  if p.stat().st_size > 0]
        rec["entry"] = {"wall_ms_traced": (time.perf_counter() - t0) * 1e3,
                        "launches": kernels.launch_counts(),
                        "n_corr": int(n_corr), "n_inliers": int(n_inl),
                        "trace_files": len(traces),
                        "trace_bytes": sum(p.stat().st_size
                                           for p in traces)}
        if not traces:
            failures.append("trace(): no trace file written")
        if not (bool(torch.isfinite(R).all()) and R.shape == (3, 3)):
            failures.append("entry(): R not a finite 3x3")
        if dev.type == "cuda" and rec["entry"]["launches"]["fast_nms"] != 2:
            failures.append(f"entry(): launches {rec['entry']['launches']}")
        # the example on the frames as PNGs
        d = tmp / "imgs"
        write_stereo_dir(d, frames, K, R_true, t_true)
        lines, wall, launches, syncs = _cli(torch, match_and_pose.main,
                                            [str(d)], device=dev)
        n_matches = int(lines[0].split()[0])
        n_inl = int(lines[-1].split()[0])
        rec["example"] = {"wall_s": wall, "launches": launches,
                          "host_syncs": syncs, "n_matches": n_matches,
                          "n_inliers": n_inl}
        if n_matches < MIN_CORR or n_inl < MIN_INLIERS:
            failures.append(f"example: {n_matches} matches, {n_inl} "
                            "inliers")
        if dev.type == "cuda" and launches != {"fast_nms": 2, "knn2": 2,
                                               "knn2_l2": 0}:
            failures.append(f"example: launches {launches}")
    return rec, failures


def library_kernel_checks(torch, knn2, seed, dev, n_sm):
    """Phase 10's kernel checks: K2b against its plain version at
    ``KNN2_L2_RAGGED`` x D = 2 and 3 (``knn2_l2_ragged_cases``), and its
    times at 2048 x 2048 x 2 on pixel coordinates of the scene's size
    beside the plain version's. Returns a record."""
    err = check_knn2_l2_ragged(torch, knn2, knn2_l2_ragged_cases(
        torch, np.random.default_rng(seed + 60), dev, depths=LIB_L2_DEPTHS))
    rng = np.random.default_rng(seed + 61)
    n = 2048
    a, b = (torch.from_numpy(np.stack(
        [rng.uniform(0, WIDTH, n), rng.uniform(0, HEIGHT, n)], axis=1)
        .astype(np.float32)).to(dev) for _ in range(2))
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    fk = functools.partial(knn2.knn2_l2, a, b, valid)
    fp = functools.partial(knn2.knn2_l2_plain, a, b, valid)
    rec = {"max_abs_err_ragged": err, "shape": [n, n, 2],
           "ms": _cuda_ms(torch, fk), "plain_ms": _cuda_ms(torch, fp)}
    rec["device_ms"], rec["kernels_per_call"] = _device_profile(torch, fk)
    rec["plain_device_ms"] = _device_ms(torch, fp)
    # the work at D = 2: the product's 2 D flops, the norms' and the
    # top-2 epilogue's 4 per pair (the kernel's zero-filled depths are not
    # work); the gate's 5 per pair for a guided call
    ops_s = (2 * n * n * 2 + 2 * 2 * n * 2 + 4 * n * n) / FP32_FLOP_S
    nbytes = 2 * n * 2 * 4 + n + n * 12
    rec["bound_ms"], rec["bound_by"] = _bound(nbytes, ops_s)
    rec["bound_ms_guided"] = _bound(nbytes, ops_s + n * n
                                    * KNN2_L2_GATE_FP32_OPS
                                    / (FP32_PER_CLK_SM * n_sm
                                       * SM_CLOCK_HZ))[0]
    if rec["kernels_per_call"] != 1:
        raise AssertionError(f"knn2_l2 D=2: {rec['kernels_per_call']} "
                             "kernels per call, not 1")
    return rec


def library_phase(torch, dev, seed, det, desc, match, robust_cfg):
    """Phase 10: the library layer (A2 estimators, A3 optical flow, A4 the
    node, the entry point, the example and trace). Returns (records by
    part, failures, wall s)."""
    from matchinglib_poselib_torch.models import pipeline

    t_phase = time.perf_counter()
    img1, img2, K, _, _ = render_scene(seed)
    corr = pipeline.get_correspondences(torch.from_numpy(img1).to(dev),
                                        torch.from_numpy(img2).to(dev),
                                        det, desc, match)
    out, failures = {}, []
    for part, fn in (
            ("estimators", lambda: library_estimators(
                torch, dev, corr, K, robust_cfg, seed)),
            ("flow", lambda: library_flow(torch, dev, seed, det, desc)),
            ("apps", lambda: library_apps(torch, dev, seed))):
        t0 = time.perf_counter()
        out[part], fails = fn()
        out[part + "_s"] = time.perf_counter() - t0
        failures.extend(f"library {part}: {f}" for f in fails)
    return out, failures, time.perf_counter() - t_phase


# ---------------------------------------------------------------------------
# phase 11, distribution: the ("pairs", "db") mesh in worlds of ranks, each
# rank a process of its own (``dist_rank``) that loads phase 1's kernels
# ---------------------------------------------------------------------------

DIST_DB_ROWS = 1 << 20  # binary db: 8 words a row, 32 MiB
DIST_FLOAT_DB_ROWS = 1 << 18  # float db: 128 floats a row, 128 MiB
DIST_SLICE_ROWS = 64  # query rows of each plain-version slice
DIST_BA_CAMERAS, DIST_BA_POINTS, DIST_BA_VISIBLE = 10, 16384, 0.7
DIST_BA_PERTURB_DEG, DIST_BA_ITERATIONS = 0.5, 8
DIST_BA_DEG, DIST_BA_ATOL = 0.05, 5e-4
DIST_STREAM_DEG = (0.2, 1.0)
DIST_FLOAT_TOL = 1e-5
DIST_TIMED_RUNS = 3
DIST_RANK_TIMEOUT_S = 300
DIST_MATCH_FIELDS = ("idx", "distance", "second_distance", "mask")


def flagship_configs(cfg):
    """The flagship step's configs: FAST t=12 at 2048 slots, ORB, GMBSOF,
    96 x 12 five-point hypotheses."""
    return (cfg.DetectorConfig(kind="FAST", max_keypoints=2048,
                               fast_threshold=12.0),
            cfg.DescriptorConfig(kind="ORB"),
            cfg.MatchingConfig(matcher_name="GMBSOF"),
            cfg.PoseConfig(robust=cfg.RobustConfig(batch_hypotheses=96,
                                                   max_batches=12)))


def dist_ba_problem(seed):
    """A keyframe window of a mapping back end: DIST_BA_CAMERAS left-camera
    poses of ``render_sequence``'s rig (0.25 m forward and 0.2 deg of yaw a
    frame), DIST_BA_POINTS points 8-40 m deep inside every view's field,
    each observation kept with probability DIST_BA_VISIBLE and 0.5 px of
    noise, cameras 1.. rotated by DIST_BA_PERTURB_DEG about a random axis,
    the points moved by 0.02 m; camera 0 fixed. Returns (the arguments of
    ``bundle_adjust`` as float32 arrays, planted R, planted t)."""
    rng = np.random.default_rng(seed + 120)
    C, P = DIST_BA_CAMERAS, DIST_BA_POINTS
    R = np.stack([_rot((0.0, 1.0, 0.0), 0.2 * f) for f in range(C)])
    t = np.stack([-R[f] @ np.array([0.0, 0.0, 0.25 * f]) for f in range(C)])
    z = rng.uniform(8.0, 40.0, P)
    X = np.stack([rng.uniform(-0.5, 0.5, P) * z,
                  rng.uniform(-0.18, 0.18, P) * z, z], axis=1)
    Xc = np.einsum("cij,pj->pci", R, X) + t[None]
    uv = Xc[..., :2] / Xc[..., 2:3] * K_FULL[[0, 1], [0, 1]] + K_FULL[:2, 2]
    inside = ((uv[..., 0] >= 0) & (uv[..., 0] < WIDTH) & (uv[..., 1] >= 0)
              & (uv[..., 1] < HEIGHT) & (Xc[..., 2] > 0))
    vis = inside & (rng.random((P, C)) < DIST_BA_VISIBLE)
    obs = uv + rng.normal(scale=0.5, size=uv.shape)
    R0 = R.copy()
    for c in range(1, C):
        R0[c] = R[c] @ _rot(_unit(rng.normal(size=3)), DIST_BA_PERTURB_DEG)
    X0 = X + rng.normal(scale=0.02, size=X.shape)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    args = (f32(obs), f32(vis), f32(R0), f32(t),
            f32(np.stack([K_FULL] * C)), np.zeros((C, 5), np.float32),
            f32(X0), f32([0.0] + [1.0] * (C - 1)))
    return args, R, t


def dist_inputs(torch, cfg, features, pipeline, sift, dev, seed, frames,
                batch):
    """The ranks' inputs as numpy arrays: the scene's right-image ORB
    descriptors (queries) and left-image ones (planted into the binary
    db), the same for SIFT (float db), the BA window, phase 6's per-frame
    stream poses and most-likely pose, phase 7's images and streams."""
    det, desc, match, _ = flagship_configs(cfg)
    img1, img2, _, _, _ = render_scene(seed)
    i1, i2 = torch.from_numpy(img1).to(dev), torch.from_numpy(img2).to(dev)
    corr = pipeline.get_correspondences(i1, i2, det, desc, match)
    bands = features.detector_bands(det)
    d1, _ = features.compute_descriptors(i1, corr.kps1, desc, bands)
    d2, _ = features.compute_descriptors(i2, corr.kps2, desc, bands)
    kp1 = features.detect_keypoints(i1, sift[0])
    kp2 = features.detect_keypoints(i2, sift[0])
    f1, _ = features.compute_descriptors(i1, kp1, sift[1])
    f2, _ = features.compute_descriptors(i2, kp2, sift[1])
    host = lambda x: x.cpu().numpy()  # noqa: E731
    (obs, vis, R0, t0, Kc, dc, X0, free), R_true, t_true = dist_ba_problem(
        seed)
    (results, n_corr), (imgs1, imgs2, K, U, D) = frames, batch
    return {
        "bin_q": host(d2), "bin_vq": host(corr.kps2.mask),
        "bin_plant": host(d1), "flt_q": host(f2), "flt_vq": host(kp2.mask),
        "flt_plant": host(f1),
        "ba_obs": obs, "ba_vis": vis, "ba_R": R0, "ba_t": t0, "ba_K": Kc,
        "ba_dist": dc, "ba_X": X0, "ba_free": free, "ba_R_true": R_true,
        "ba_t_true": t_true,
        "stream_R": np.float32([r.R for r in results]),
        "stream_t": np.float32([r.t for r in results]),
        "stream_w": np.float32([max(r.inlier_ratio, 1e-3) * n
                                for r, n in zip(results, n_corr)]),
        "stream_R_ml": results[-1].R_most_likely,
        "stream_t_ml": results[-1].t_most_likely,
        "batch_imgs1": host(imgs1), "batch_imgs2": host(imgs2),
        "batch_K": host(K), "batch_U": host(U), "batch_D": host(D),
    }


def dist_databases(torch, dev, inputs, seed):
    """The seeded databases on `dev`, the same bits in every process: the
    binary one (DIST_DB_ROWS random 8-word rows, the left image's ORB
    descriptors planted at spread rows) and the float one
    (DIST_FLOAT_DB_ROWS random non-negative unit rows, as SIFT's, the left
    image's SIFT descriptors planted at spread rows)."""
    g = torch.Generator(device=dev).manual_seed(seed + 110)
    db = torch.randint(-2**31, 2**31, (DIST_DB_ROWS, 8), generator=g,
                       device=dev, dtype=torch.int64).to(torch.int32)
    fdb = torch.randn((DIST_FLOAT_DB_ROWS, 128), generator=g, device=dev)
    fdb = torch.abs(fdb)
    fdb = fdb / torch.linalg.norm(fdb, dim=1, keepdim=True)
    for table, key in ((db, "bin_plant"), (fdb, "flt_plant")):
        plant = torch.from_numpy(inputs[key]).to(dev)
        rows = np.linspace(0, table.shape[0] - 1, plant.shape[0])
        table[torch.from_numpy(rows.astype(np.int64)).to(dev)] = plant
    return db, fdb


def _collective_split(torch, pmesh, fn):
    """One call of `fn` with each collective of ``parallel.mesh`` timed
    alone (a sync before and after it, so the time includes waiting for
    the other ranks): {ms in collectives, the call's ms, count of each}."""
    counts = {"all_reduce": 0, "all_gather": 0}
    orig = {k: getattr(pmesh, k) for k in counts}
    spent = [0.0]

    def timed(name):
        def call(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig[name](*a, **kw)
            torch.cuda.synchronize()
            spent[0] += time.perf_counter() - t0
            counts[name] += 1
            return out
        return call

    for k in counts:
        setattr(pmesh, k, timed(k))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        call_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for k, f in orig.items():
            setattr(pmesh, k, f)
    return {"ms": spent[0] * 1e3, "call_ms": call_ms, **counts}


def _dist_measure(torch, kernels, pmesh, fn):
    """A function of a rank: the counted call (launch counts from 0 just
    before, read just after; host syncs), a barrier, DIST_TIMED_RUNS timed
    calls (host clock ending in a sync), one call with the collectives timed
    alone, one profiled call (device busy ms, device ops, its 3 costliest
    kernels). Returns (the counted call's output, record)."""
    from matchinglib_poselib_torch.utils.profiling import HostSyncs

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    s0 = HostSyncs.count
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    rec = {"warm_ms": (time.perf_counter() - t0) * 1e3,
           "launches": kernels.launch_counts(),
           "host_syncs": HostSyncs.count - s0}
    # the ranks start the timed calls together: a rank's first timed call
    # would otherwise wait in a collective for another's counted call
    torch.distributed.barrier()
    ms = []
    for _ in range(DIST_TIMED_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    rec["ms"], rec["ms_mean"] = ms, float(np.mean(ms))
    rec["ms_median"] = float(np.median(ms))
    rec["collectives"] = _collective_split(torch, pmesh, fn)
    try:
        device, _ = _device_events(torch, fn)
    except RuntimeError as e:  # a measurement, not a check: not measured
        rec["device_busy_ms"] = rec["device_ops"] = None
        rec["profiler_error"] = str(e).splitlines()[0][:200]
        return out, rec
    rec["device_busy_ms"] = sum(e.self_device_time_total
                                for e in device) / 1e3
    rec["device_ops"] = sum(e.count for e in device)
    rec["top_kernels"] = [[e.key[:60], e.self_device_time_total / 1e3,
                           e.count] for e in device[:3]]
    return out, rec


def _rank_device(torch, rank):
    """A rank's card: one per rank while there are cards, else shared."""
    return torch.device("cuda", rank % torch.cuda.device_count())


def dist_rank(rank, world, backend, port, tmp, seed) -> int:
    """One rank of a phase 11 world (run in a process of its own): joins
    the world at tcp://127.0.0.1:`port`, runs and measures each
    distributed function on its card, runs ``dryrun_multichip``, and
    writes its outputs to `tmp`/<backend><world>_rank<r>.npz and its
    records to .json, with the seconds since its start at which each
    step ended (``timeline_s``)."""
    import datetime

    t_start = time.perf_counter()
    timeline = {}

    def mark(step):
        timeline[step] = time.perf_counter() - t_start

    import torch
    import torch.distributed as dist

    from matchinglib_poselib_torch import config as cfg, entry
    from matchinglib_poselib_torch.models import pipeline
    from matchinglib_poselib_torch.ops import kernels
    from matchinglib_poselib_torch.parallel import mesh as pmesh, stream
    from matchinglib_poselib_torch.parallel.ba import bundle_adjust_sharded
    from matchinglib_poselib_torch.parallel.matching import sharded_match

    mark("imports")
    dev = _rank_device(torch, rank)
    torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=DIST_RANK_TIMEOUT_S))
    inp = dict(np.load(f"{tmp}/inputs.npz"))

    def on(key):
        return torch.from_numpy(inp[key]).to(dev)

    db, fdb = dist_databases(torch, dev, inp, seed)
    mark("world, inputs and databases")
    # matching and BA shard over db (1 x world), frames and pairs over
    # pairs (world x 1)
    m_db = pmesh.make_mesh(world, device=dev)
    m_pairs = m_db if world == 1 else pmesh.make_mesh(1, device=dev)
    mark("meshes")
    blk = functools.partial(pmesh.db_block, m_db)
    ones = functools.partial(torch.ones, dtype=torch.bool, device=dev)
    ba_args = [on(f"ba_{k}") for k in ("obs", "vis", "R", "t", "K", "dist",
                                       "X", "free")]
    fns = {
        "binary_match": lambda: sharded_match(
            m_db, on("bin_q"), blk(db), on("bin_vq"), blk(ones(len(db)))),
        "float_match": lambda: sharded_match(
            m_db, on("flt_q"), blk(fdb), on("flt_vq"), blk(ones(len(fdb))),
            binary=False),
        "bundle_adjust": lambda: bundle_adjust_sharded(
            m_db, *ba_args, iterations=DIST_BA_ITERATIONS),
    }
    if world > 1:
        det, desc, match, pose_cfg = flagship_configs(cfg)
        pipe = pipeline.StereoPipeline(det, desc, match, pose_cfg,
                                       device=dev)
        Kt, dz = on("batch_K"), torch.zeros(5, device=dev)
        i1, i2, U, D = (pmesh.pairs_block(m_pairs, on(f"batch_{k}"))
                        for k in ("imgs1", "imgs2", "U", "D"))
        fns["consensus"] = lambda: stream.windowed_pose_consensus(
            m_pairs, *(stream.frame_window_block(m_pairs, on(f"stream_{k}"))
                       for k in ("R", "t", "w")))
        fns["pairs_batch"] = lambda: pipe.run_batch(
            i1, i2, Kt, Kt, dz, dz, uniforms=U, degen_uniforms=D)
    out, recs = {}, {}
    for name, fn in fns.items():
        res, recs[name] = _dist_measure(torch, kernels, pmesh, fn)
        if name.endswith("_match"):
            q, table = ("bin_q", db) if name == "binary_match" else (
                "flt_q", fdb)
            recs[name]["shape"] = [len(inp[q]), len(blk(table)),
                                   table.shape[1]]
        if name == "pairs_batch":
            corr, pose = res
            res = {"kps1_mask": corr.kps1.mask, "kps1_xy": corr.kps1.xy,
                   "kps2_mask": corr.kps2.mask, "kps2_xy": corr.kps2.xy,
                   "pts2": corr.pts2, "mask": corr.mask, "R": pose.R,
                   "t": pose.t, "inlier_mask": pose.inlier_mask}
        else:
            res = res._asdict() if hasattr(res, "_asdict") else dict(
                zip(("R", "t", "wsum"), res))
        out.update({f"{name}/{k}": v.cpu().numpy() for k, v in res.items()})
        mark(name)
    if world == 1:
        # the LM loop with its all-reduces reads nothing on the host
        recs["bundle_adjust"]["sync_debug_failures"] = check_no_host_sync(
            torch, "bundle_adjust_sharded", fns["bundle_adjust"])
    t0 = time.perf_counter()
    dry = entry.dryrun_multichip(device=dev)
    recs["dryrun"] = {"s": time.perf_counter() - t0,
                      "mesh": list(dry.mesh_shape),
                      "ba_vs_single": dry.ba_vs_single,
                      "consensus_rot_deg": dry.consensus_rot_deg}
    mark("dryrun")
    recs["timeline_s"] = timeline
    recs["mesh_db"] = [pmesh.axis_size(m_db, a) for a in (pmesh.PAIRS_AXIS,
                                                          pmesh.DB_AXIS)]
    recs["mesh_pairs"] = [pmesh.axis_size(m_pairs, a)
                          for a in (pmesh.PAIRS_AXIS, pmesh.DB_AXIS)]
    recs["coordinate"] = [pmesh.axis_index(m_pairs, pmesh.PAIRS_AXIS),
                          pmesh.axis_index(m_db, pmesh.DB_AXIS)]
    dist.barrier()
    dist.destroy_process_group()
    name = f"{tmp}/{backend}{world}_rank{rank}"
    np.savez(name + ".npz", **out)
    with open(name + ".json", "w") as f:
        json.dump(recs, f)
    return 0


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_world(backend, world, tmp, seed, prelude=""):
    """Start the `world` ranks of a world (one process each) and wait for
    them, DIST_RANK_TIMEOUT_S at most: (per-rank outputs and records, or
    None, failures). `prelude`: Python run in each rank before it starts
    (``chip_probes/distribution_rehearsal.py`` replaces the card's calls
    there)."""
    import os

    port = _free_port()
    here = os.path.dirname(os.path.abspath(__file__))
    procs = []
    for r in range(world):
        code = (f"import sys; sys.path.insert(0, {here!r}); import chip_smoke\n"
                f"{prelude}\nsys.exit(chip_smoke.dist_rank({r}, {world}, "
                f"{backend!r}, {port}, {tmp!r}, {seed}))")
        log = open(f"{tmp}/{backend}{world}_rank{r}.log", "w")
        procs.append((subprocess.Popen([sys.executable, "-c", code],
                                       stdout=log, stderr=subprocess.STDOUT,
                                       cwd=here), log))
    deadline = time.monotonic() + DIST_RANK_TIMEOUT_S
    failures = []
    try:
        for r, (p, _) in enumerate(procs):
            try:
                rc = p.wait(timeout=max(deadline - time.monotonic(), 1.0))
            except subprocess.TimeoutExpired:
                failures.append(f"{backend} x{world} rank {r}: timed out "
                                f"after {DIST_RANK_TIMEOUT_S} s")
                break
            if rc != 0:
                failures.append(f"{backend} x{world} rank {r}: exit {rc}")
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    if failures:
        for r in range(world):
            with open(f"{tmp}/{backend}{world}_rank{r}.log") as f:
                tail = f.read()[-3000:]
            print(f"[{backend} x{world} rank {r}]\n{tail}", file=sys.stderr)
        return None, failures
    ranks = []
    for r in range(world):
        name = f"{tmp}/{backend}{world}_rank{r}"
        with open(name + ".json") as f:
            ranks.append((dict(np.load(name + ".npz")), json.load(f)))
    return ranks, failures


def dist_references(torch, matching, knn2, ba, inputs, db, fdb, dev):
    """What every world is held to, computed in this process on the card:
    ``match_descriptors`` over the whole databases (the kernels over all
    rows, no ratio fallback), the plain versions on DIST_SLICE_ROWS-row
    slices of the queries, and single-card ``bundle_adjust``."""
    on = lambda k: torch.from_numpy(inputs[k]).to(dev)  # noqa: E731
    refs = {}
    for kind, table, binary in (("bin", db, True), ("flt", fdb, False)):
        q, vq = on(f"{kind}_q"), on(f"{kind}_vq")
        vdb = torch.ones(len(table), dtype=torch.bool, device=dev)
        res = matching.match_descriptors(q, table, vq, vdb, binary=binary,
                                         ratio_fallback=False)
        refs[kind] = {k: getattr(res, k).cpu().numpy()
                      for k in DIST_MATCH_FIELDS}
        plain = knn2.knn2_plain if binary else knn2.knn2_l2_plain
        n = q.shape[0]
        refs[kind + "_slices"] = []
        for a in (0, n // 2 - DIST_SLICE_ROWS // 2, n - DIST_SLICE_ROWS):
            s = slice(a, a + DIST_SLICE_ROWS)
            refs[kind + "_slices"].append(
                (s, [x.cpu().numpy() for x in plain(q[s], table, vdb)]))
    args = [on(f"ba_{k}") for k in ("obs", "vis", "R", "t", "K", "dist", "X",
                                    "free")]
    res = ba.bundle_adjust(*args, iterations=DIST_BA_ITERATIONS)
    refs["ba"] = {"R": res.R.cpu().numpy(), "t": res.t.cpu().numpy()}
    return refs


def _dist_match_checks(label, kind, out, refs, vq, exact):
    """A world's sharded match against the whole-db reference and the
    plain slices: exact for Hamming, DIST_FLOAT_TOL (1 + |d|) for squared
    L2 with idx and mask held where no near tie decides them. An invalid
    query is (1e9, 1e9, 0), not kept, as in the JAX package."""
    fails = []
    got = {k: out[f"{kind}/{k}"] for k in DIST_MATCH_FIELDS}
    ref = refs["bin" if exact else "flt"]
    inval = ~vq
    if inval.any() and not (np.all(got["distance"][inval] == 1e9)
                            and np.all(got["idx"][inval] == 0)
                            and not got["mask"][inval].any()):
        fails.append(f"{label} {kind}: invalid queries not (1e9, 1e9, 0)")
    if exact:
        for k in ("idx", "distance", "second_distance"):
            if not np.array_equal(got[k][vq], ref[k][vq]):
                fails.append(f"{label} {kind}: {k} != whole-db knn2")
        if not np.array_equal(got["mask"], ref["mask"]):
            fails.append(f"{label} {kind}: mask != whole-db match")
    else:
        tol = DIST_FLOAT_TOL * (1.0 + np.abs(ref["distance"]))
        for k in ("distance", "second_distance"):
            if np.any(np.abs(got[k] - ref[k])[vq] > tol[vq]):
                fails.append(f"{label} {kind}: {k} off the whole-db K2b")
        clear = vq & (ref["second_distance"] - ref["distance"] > tol)
        clear &= np.abs(ref["distance"] - 0.8 * ref["second_distance"]) > tol
        if not np.array_equal(got["idx"][clear], ref["idx"][clear]):
            fails.append(f"{label} {kind}: idx != whole-db K2b")
        if not np.array_equal(got["mask"][clear], ref["mask"][clear]):
            fails.append(f"{label} {kind}: mask != whole-db match")
    for s, (d1, d2, idx) in refs[("bin" if exact else "flt") + "_slices"]:
        v = vq[s]
        g1, g2, gi = (got[k][s][v] for k in ("distance", "second_distance",
                                              "idx"))
        if exact:
            ok = (np.array_equal(g1, d1[v]) and np.array_equal(g2, d2[v])
                  and np.array_equal(gi, idx[v]))
        else:
            tol = DIST_FLOAT_TOL * (1.0 + np.abs(d1[v]))
            clear = d2[v] - d1[v] > tol
            ok = (np.all(np.abs(g1 - d1[v]) <= tol)
                  and np.array_equal(gi[clear], idx[v][clear]))
        if not ok:
            fails.append(f"{label} {kind}: rows {s.start}-{s.stop} != the "
                         "plain version")
    return fails


def _dist_checks(torch, label, world, ranks, inputs, refs, phase7):
    """Every check of a world. Returns (failures, the checked values:
    BA's worst camera against the planted pose and against single-card BA,
    the consensus against phase 6, each pair of the batch against phase
    7)."""
    fails, seen = [], {}
    out0 = ranks[0][0]
    for r, (out, _) in enumerate(ranks[1:], 1):
        for k, v in out0.items():
            # each rank's own block of pairs; the rest is replicated
            if not k.startswith("pairs_batch/") and not np.array_equal(
                    out[k], v):
                fails.append(f"{label}: rank {r}'s {k} != rank 0's")
    for kind, key, exact, kernel in (
            ("binary_match", "bin_vq", True, "knn2"),
            ("float_match", "flt_vq", False, "knn2_l2")):
        fails += _dist_match_checks(label, kind, out0, refs, inputs[key],
                                    exact)
        for r, (_, rec) in enumerate(ranks):
            want = {"fast_nms": 0, "knn2": 0, "knn2_l2": 0, kernel: 2}
            if rec[kind]["launches"] != want:
                fails.append(f"{label} rank {r} {kind}: launches "
                             f"{rec[kind]['launches']}, expected {want}")
    R, t = out0["bundle_adjust/R"], out0["bundle_adjust/t"]
    errs = [_rot_deg(R[c], inputs["ba_R_true"][c])
            for c in range(DIST_BA_CAMERAS)]
    fails += [f"{label} BA camera {c}: {e:.4f} deg off"
              for c, e in enumerate(errs) if e >= DIST_BA_DEG]
    diff = float(max(np.abs(R - refs["ba"]["R"]).max(),
                     np.abs(t - refs["ba"]["t"]).max()))
    seen["ba_worst_camera_deg"], seen["ba_vs_single_card"] = max(errs), diff
    if diff > DIST_BA_ATOL:
        fails.append(f"{label} BA cameras {diff} from single-card BA")
    fails += ranks[0][1]["bundle_adjust"].get("sync_debug_failures", [])
    if world > 1:
        rd = _rot_deg(out0["consensus/R"], inputs["stream_R_ml"])
        td = _dir_deg(out0["consensus/t"], inputs["stream_t_ml"])
        seen["consensus_vs_phase6_deg"] = [rd, td]
        if rd >= DIST_STREAM_DEG[0] or td >= DIST_STREAM_DEG[1]:
            fails.append(f"{label} consensus {rd:.4f} / {td:.4f} deg from "
                         "phase 6's most-likely pose")
        from types import SimpleNamespace as NS

        corr7, pose7 = phase7
        n_blk = len(ranks[0][0]["pairs_batch/R"])
        for r, (out, rec) in enumerate(ranks):
            def t_(k):
                return torch.from_numpy(out[f"pairs_batch/{k}"])
            singles = [(NS(kps1=NS(mask=t_("kps1_mask")[i],
                                   xy=t_("kps1_xy")[i]),
                           kps2=NS(mask=t_("kps2_mask")[i],
                                   xy=t_("kps2_xy")[i]),
                           pts2=t_("pts2")[i], mask=t_("mask")[i]),
                        NS(inlier_mask=t_("inlier_mask")[i], R=t_("R")[i],
                           t=t_("t")[i])) for i in range(n_blk)]
            blk = slice(r * n_blk, (r + 1) * n_blk)
            rows, f = batch_vs_run(torch, NS(
                kps1=NS(mask=corr7.kps1.mask[blk].cpu(),
                        xy=corr7.kps1.xy[blk].cpu()),
                kps2=NS(mask=corr7.kps2.mask[blk].cpu(),
                        xy=corr7.kps2.xy[blk].cpu()),
                pts2=corr7.pts2[blk].cpu(), mask=corr7.mask[blk].cpu()),
                NS(inlier_mask=pose7.inlier_mask[blk].cpu(),
                   R=pose7.R[blk].cpu(), t=pose7.t[blk].cpu()), singles)
            fails += [f"{label} rank {r} pairs batch vs phase 7: {x}"
                      for x in f]
            seen.setdefault("pairs_vs_phase7", []).extend(rows)
            want = {"fast_nms": 1, "knn2": 2 * n_blk, "knn2_l2": 0}
            if rec["pairs_batch"]["launches"] != want:
                fails.append(f"{label} rank {r} pairs batch: launches "
                             f"{rec['pairs_batch']['launches']}, expected "
                             f"{want}")
    return fails, seen


def distribution_phase(torch, cfg, sift, dev, seed, smi, stream, batch,
                       prelude=""):
    """Phase 11: the distributed paths in worlds of ranks on the card(s).
    (a) a world of 1 over NCCL; (b) a world of 2 ranks sharing cuda:0 over
    gloo (the compute on the card, the collectives through gloo); (c) with
    2 or more cards, NCCL with one rank per card (2 or 4). Each world runs
    binary and float ``sharded_match`` against seeded databases of
    DIST_DB_ROWS / DIST_FLOAT_DB_ROWS rows, ``bundle_adjust_sharded`` on
    ``dist_ba_problem`` and ``dryrun_multichip``; (b) and (c) also the
    consensus over phase 6's frames and phase 7's batch split over the
    pairs ranks. `stream`: (phase 6's FrameResults, their correspondence
    counts); `batch`: phase 7's (corr, pose, (imgs1, imgs2, K, U, D));
    `prelude`: as ``run_world``'s. Returns (records by world, failures,
    wall s)."""
    import tempfile

    from matchinglib_poselib_torch.models import pipeline
    from matchinglib_poselib_torch.ops import ba, features, matching
    from matchinglib_poselib_torch.ops.kernels import knn2

    t_phase = time.perf_counter()
    corr7, pose7, batch_inputs = batch
    failures, recs = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        inputs = dist_inputs(torch, cfg, features, pipeline, sift, dev, seed,
                             stream, batch_inputs)
        np.savez(f"{tmp}/inputs.npz", **inputs)
        db, fdb = dist_databases(torch, dev, inputs, seed)
        refs = dist_references(torch, matching, knn2, ba, inputs, db, fdb,
                               dev)
        del db, fdb
        worlds = [("nccl", 1, "a: NCCL, 1 rank on cuda:0"),
                  ("gloo", 2, "b: gloo, 2 ranks sharing cuda:0")]
        n_cards = torch.cuda.device_count()
        if n_cards >= 2:
            n = 4 if n_cards >= 4 else 2
            worlds.append(("nccl", n, f"c: NCCL, {n} ranks, one per card"))
        else:
            recs["c"] = {"not_run": f"{n_cards} card: NCCL with one rank per "
                                    "card needs 2 or more"}
        first = None
        for backend, world, label in worlds:
            t0 = time.perf_counter()
            ranks, fails = run_world(backend, world, tmp, seed, prelude)
            failures += [f"distribution {x}" for x in fails]
            if ranks is None:
                continue
            fails, seen = _dist_checks(torch, label, world, ranks, inputs,
                                       refs, (corr7, pose7))
            failures += [f"distribution {x}" for x in fails]
            # the Hamming fields: the same bits in every world
            hamming = {k: v for k, v in ranks[0][0].items()
                       if k.startswith("binary_match/")}
            first = first or hamming
            failures += [f"distribution {label}: {k} != world (a)'s"
                         for k, v in hamming.items()
                         if not np.array_equal(v, first[k])]
            recs[label] = {"s": time.perf_counter() - t0, "checks": seen,
                           "ranks": [rec for _, rec in ranks]}
    return recs, failures, time.perf_counter() - t_phase


def dist_knn_bound(binary, n1, n2, width, n_sm):
    """(bound ms, what bounds it) of one 2-NN launch of n1 queries against
    n2 candidates, unguided, by phase 3's rules: K2a the lesser of the
    POPC and the tensor-core route (its 32-bit epilogue at its least),
    K2b the fp32 product, norms and epilogue at the fp32 peak."""
    pairs, sm_clk_s = n1 * n2, n_sm * SM_CLOCK_HZ
    nbytes = (n1 + n2) * width * 4 + n2 + n1 * 12
    if not binary:
        return _bound(nbytes, (2 * pairs * width + 2 * (n1 + n2) * width
                               + 4 * pairs) / FP32_FLOP_S)
    popc = _bound(nbytes, pairs * width / (POPC_PER_CLK_SM * sm_clk_s))
    tc = _bound(nbytes, pairs / sm_clk_s * max(
        2 * 32 * width / BMMA_OPS_PER_CLK_SM,
        KNN2_INT_OPS[0] / INT32_PER_CLK_SM))
    return min(popc, tc)


def dist_lines(recs, smi, n_sm):
    """Phase 11's ``distribution`` JSON lines (one per world and function,
    per-rank lists; for a match, each launch's bound at the rank's shape)
    and its launches per call by world and function."""
    lines, launches = [], {}
    meta = ("dryrun", "mesh_db", "mesh_pairs", "coordinate", "timeline_s")
    for label, w in recs.items():
        if "ranks" not in w:
            lines.append({"distribution": "world", "world": label, "card": smi,
                          **w})
            continue
        ranks = w["ranks"]
        launches[label] = {}
        for fn in (k for k in ranks[0] if k not in meta):
            per = [r[fn] for r in ranks]
            mesh = ranks[0]["mesh_pairs" if fn in ("consensus", "pairs_batch")
                            else "mesh_db"]
            line = {"distribution": fn, "world": label, "card": smi,
                    "mesh": mesh,
                    "ms_mean_per_rank": [p["ms_mean"] for p in per],
                    "ms_median_per_rank": [p["ms_median"] for p in per],
                    "ms_per_rank": [p["ms"] for p in per],
                    "warm_ms_per_rank": [p["warm_ms"] for p in per],
                    "collective_ms_per_rank": [p["collectives"]["ms"]
                                               for p in per],
                    "collective_call_ms_per_rank": [p["collectives"]["call_ms"]
                                                    for p in per],
                    "collectives": {k: per[0]["collectives"][k]
                                    for k in ("all_reduce", "all_gather")},
                    "launches": per[0]["launches"],
                    "host_syncs_per_rank": [p["host_syncs"] for p in per],
                    "device_ops_per_rank": [p["device_ops"] for p in per],
                    "device_busy_ms_per_rank": [p["device_busy_ms"]
                                                for p in per]}
            if "top_kernels" in per[0]:
                line["top_kernels_rank0"] = per[0]["top_kernels"]
            if "shape" in per[0]:
                n_q, rows, width = line["shape_per_rank"] = per[0]["shape"]
                fwd = dist_knn_bound(fn == "binary_match", n_q, rows, width,
                                     n_sm)
                # the cross-check's reverse: the n_q rows the matches name
                rev = dist_knn_bound(fn == "binary_match", n_q, n_q, width,
                                     n_sm)
                line["bound_ms_forward_reverse"] = [fwd[0], rev[0]]
                line["bound_by"] = fwd[1]
            if fn == "bundle_adjust":
                # 2 before the loop (the visible count, the first cost)
                line["all_reduces_per_lm_iteration"] = (
                    per[0]["collectives"]["all_reduce"] - 2
                ) / DIST_BA_ITERATIONS
                if "sync_debug_failures" in per[0]:
                    line["sync_debug_failures"] = per[0]["sync_debug_failures"]
            lines.append(line)
            launches[label][fn] = per[0]["launches"]
        lines.append({"distribution": "checks", "world": label, "card": smi,
                      **w["checks"]})
        lines.append({"distribution": "dryrun_multichip", "world": label,
                      "card": smi, "per_rank": [r["dryrun"] for r in ranks],
                      "world_s": w["s"],
                      "timeline_s_per_rank": [r["timeline_s"] for r in ranks]})
    return lines, launches


# ---------------------------------------------------------------------------
# phase 12: the three kernels over the JAX package's whole input domain
# ---------------------------------------------------------------------------

# K1 below 0: thresholds in [0, 1] intensity units, NMS radii
DOMAIN_K1_THRESHOLDS = (-12.0 / 255.0, -1.0 / 255.0)
DOMAIN_K1_RADII = (0, 3)
# K1 per pixel at t < 0: the dark side's own argument, -d - t, is 16 FADD
# more on the fp32 pipe; the compare / integer pipe is unchanged
K1_FP32_OPS_NEG = K1_FP32_OPS + 16
# K2a's maps (words, rows): past one column slice of a launch at the
# width's first key layout (2^21 at 8 words, 2^20 at 16), past one launch
# (2^24, 2^23)
DOMAIN_MAPS = ((8, 2_097_153), (8, 4_194_304), (8, 16_781_312),
               (16, 1_048_577), (16, 8_388_609))
DOMAIN_SHARDED_MAP = (8, 16_781_312)  # sharded_match's binary map
DOMAIN_CHECK_ROWS = 64  # query rows held against the chunked plain search
DOMAIN_PLAIN_COLS = 1 << 20  # columns per chunk of the plain search
DOMAIN_PLAIN_ROWS = 256  # query rows per block of a whole-map plain search
DOMAIN_INVALID = 0.05  # share of invalid map rows
DOMAIN_DUPS = 4  # queries copied onto both sides of each boundary
DOMAIN_STRONG = 30  # a pair match this close must come back from the map
DOMAIN_WIDE_WORDS = (17, 24, 32, 64)
DOMAIN_L2_DEPTHS = (641, 1024, 2048)
DOMAIN_L2_CHUNK = 1000  # a K2b column chunk that splits 2048 columns
DOMAIN_FLOAT_MAP = (65_536, 1024)  # sharded_match's float map: rows, D
DOMAIN_TIMED_RUNS = 3


def _launches(kernel, fn):
    """Launches of `kernel` ("fast_nms", "knn2" or "knn2_l2") in one call
    of `fn`."""
    from matchinglib_poselib_torch.ops import kernels

    before = kernels.launch_counts()[kernel]
    fn()
    return kernels.launch_counts()[kernel] - before


def k2a_bound(n1, n2, words, guided, n_sm):
    """Phase 3's K2a bound at (n1, n2, words): the lesser of the POPC
    route and the tensor-core route (the b1 product, the integer and the
    fp32 epilogue, side by side), against the bytes. Returns (ms, by)."""
    sm_clk_s = n_sm * SM_CLOCK_HZ
    pairs = n1 * n2
    nbytes = (n1 + n2) * 4 * words + n2 + n1 * 12
    popc = _bound(nbytes, pairs * words / (POPC_PER_CLK_SM * sm_clk_s))
    tc = _bound(nbytes, pairs / sm_clk_s * max(
        2 * 32 * words / BMMA_OPS_PER_CLK_SM,
        KNN2_INT_OPS[guided] / INT32_PER_CLK_SM,
        KNN2_FP32_OPS[guided] / FP32_PER_CLK_SM))
    return min(popc, tc)


def k2b_bound(n1, n2, depth, guided, n_sm):
    """Phase 3b's K2b bound: the product, the norms and the epilogue's 4
    fp32 ops per pair at the fp32 peak, the gate's 5 per pair on top,
    against the bytes. Returns (ms, by)."""
    ops_s = (2 * n1 * n2 * depth + 2 * (n1 + n2) * depth
             + 4 * n1 * n2) / FP32_FLOP_S
    if guided:
        ops_s += n1 * n2 * KNN2_L2_GATE_FP32_OPS / (
            FP32_PER_CLK_SM * n_sm * SM_CLOCK_HZ)
    return _bound((n1 + n2) * depth * 4 + n2 + n1 * 12, ops_s)


def _k1_flat(torch, rng, dev):
    """A (1, 96, 200) image whose left half is flat (a region that scores
    16 |t| at every pixel at t < 0, where the NMS decides on ties) and
    whose right half is uniform noise."""
    img = np.full((1, 96, 200), 0.5, np.float32)
    img[:, :, 100:] = rng.random((1, 96, 100), np.float32)
    return torch.from_numpy(img).to(dev)


def domain_k1(torch, fast_nms, scene, dev, seed, n_sm):
    """K1 at t < 0 (its own instantiation): every pixel of the scene's (1,
    H, W) and (2, H, W) stacks and of a half-flat image against the plain
    version of the input zero-padded by 3 + r (``check_fast_nms``), at
    each of DOMAIN_K1_THRESHOLDS x DOMAIN_K1_RADII: max abs err 0 and no
    tie mismatch; device ms, kernels per call and the bound at (1, H, W),
    t = -12/255, r = 3. Returns (record, failures)."""
    one = scene[0]
    flat = _k1_flat(torch, np.random.default_rng(seed + 120), dev)
    rec, fails = {"checks": []}, []
    for t in DOMAIN_K1_THRESHOLDS:
        for r in DOMAIN_K1_RADII:
            for imgs, least in ((one, 1000), (scene[1], 1000), (flat, 10)):
                err, ties = check_fast_nms(torch, fast_nms, imgs, t, r,
                                           min_corners=least)
                rec["checks"].append([list(imgs.shape), t, r, err, ties])
                if err or ties:
                    fails.append(f"fast_nms t={t} r={r} {tuple(imgs.shape)}"
                                 f": max abs err {err}, {ties} tie "
                                 "mismatches")
    t, r = DOMAIN_K1_THRESHOLDS[0], 3
    k = functools.partial(fast_nms.fast_nms_score, one, t, r)
    p = functools.partial(fast_nms.fast_nms_score_plain, one, t, r)
    rec.update(shape=list(one.shape), threshold=t, radius=r,
               launches_per_call=_launches("fast_nms", k),
               ms=_cuda_ms(torch, k), plain_ms=_cuda_ms(torch, p))
    rec["device_ms"], rec["kernels_per_call"] = _device_profile(torch, k)
    rec["plain_device_ms"] = _device_ms(torch, p)
    if rec["launches_per_call"] != 1:
        fails.append(f"fast_nms t={t}: {rec['launches_per_call']} launches "
                     "per call, not 1")
    n_px, sm_clk_s = one.numel(), n_sm * SM_CLOCK_HZ
    pipes = {"fp32": n_px * K1_FP32_OPS_NEG / (FP32_PER_CLK_SM * sm_clk_s),
             "compare/int": n_px * (K1_ALU_OPS + k1_window_ops(r))
             / (INT32_PER_CLK_SM * sm_clk_s)}
    pipe = max(pipes, key=pipes.get)
    rec["bound_ms"], rec["bound_by"] = _bound(2 * n_px * 4, pipes[pipe])
    rec["bound_pipe"] = pipe if rec["bound_by"] == "operations" else "memory"
    rec["bound_pipes_ms"] = {k: v * 1e3 for k, v in pipes.items()}
    return rec, fails


def plain_chunked(torch, knn2, q, table, valid, pred=None, rad2=None,
                  pts2=None, xy_mode=0):
    """``knn2_plain`` of the rows of `q` against `table`, chunk by chunk
    of DOMAIN_PLAIN_COLS columns on the card, the chunks merged by
    ``knn2.merge_top2`` (ties to the lower columns)."""
    outs = []
    for c0 in range(0, table.shape[0], DOMAIN_PLAIN_COLS):
        sl = slice(c0, c0 + DOMAIN_PLAIN_COLS)
        d1, d2, i1 = knn2.knn2_plain(
            q, table[sl], valid[sl], pred,
            rad2[sl] if xy_mode == 2 else rad2,
            pts2[sl] if xy_mode else None, xy_mode)
        outs.append((d1, d2, torch.where(i1 >= 0, i1 + c0, -1)))
    return knn2.merge_top2(*(torch.stack(x) for x in zip(*outs)))


def domain_map(torch, knn2, n_rows, queries, plants, pred, seed, dev):
    """A seeded map of `n_rows` random rows of the queries' width
    (DOMAIN_INVALID of them invalid, at random positions in the image,
    each with a random gate radius) holding a copy of every `plants`
    descriptor at its keypoint's position, in the map's upper half and
    its last rows; and, on both sides of the first launch's first slice
    boundary and (past one launch) of the launch boundary, two exact
    copies of one query at its predicted position (query 0 at the first
    boundary, 1 at the second): the lower row must win. `queries`,
    `plants`: (descriptors, keypoint xy); `pred` the queries' predicted
    positions. Returns a dict of the map's tensors, the planted rows and
    the boundaries."""
    (q, _), (p, p_xy) = queries, plants
    words = q.shape[1]
    g = torch.Generator(device=dev).manual_seed(seed)
    table = torch.randint(-2**31, 2**31, (n_rows, words), generator=g,
                          device=dev, dtype=torch.int64).to(torch.int32)
    valid = torch.rand(n_rows, generator=g, device=dev) >= DOMAIN_INVALID
    pts2 = torch.rand((n_rows, 2), generator=g, device=dev) * torch.tensor(
        [WIDTH, HEIGHT], dtype=torch.float32, device=dev)
    rad_c = (20.0 + 60.0 * torch.rand(n_rows, generator=g, device=dev)) ** 2
    cap = knn2.max_columns(knn2.kernel_words(words))
    bounds = [(min(n_rows, cap) + 7) // 8]  # the first slice boundary
    if n_rows > cap:
        bounds.append(cap)
    dup_rows = np.array([b + o for b in bounds for o in (-1, 0)])
    n_p = p.shape[0]
    last = np.setdiff1d(np.arange(n_rows - n_p, n_rows),
                        dup_rows)[-(n_p // 2):]
    spread = np.setdiff1d(
        np.linspace(n_rows // 2, last[0] - 1, n_p).astype(np.int64),
        dup_rows)[:n_p - len(last)]
    rows = np.concatenate([spread, last])
    if len(np.unique(rows)) != n_p or np.isin(dup_rows, rows).any():
        raise AssertionError(f"map of {n_rows}: planted rows collide")
    prow = torch.from_numpy(rows).to(dev)
    table[prow], valid[prow], pts2[prow] = p, True, p_xy
    for j, b in enumerate(bounds):
        table[b - 1:b + 1] = q[j]
        valid[b - 1:b + 1] = True
        pts2[b - 1:b + 1] = pred[j]
    return {"table": table, "valid": valid, "pts2": pts2, "rad_c": rad_c,
            "plant_rows": prow, "bounds": bounds, "words": words}


def domain_check_rows(torch, m, strong, pair_idx, n_q):
    """DOMAIN_CHECK_ROWS query rows to hold against the plain search: the
    boundary duplicates' queries, the strong pair matches planted in the
    highest rows (past the boundaries), evenly spaced queries after."""
    dups = list(range(len(m["bounds"])))
    hi = torch.where(strong, m["plant_rows"][pair_idx.clamp(min=0).long()],
                     -1)
    top = [int(i) for i in torch.argsort(hi, descending=True)[:32].cpu()
           if int(hi[i]) >= 0]
    rows = list(dict.fromkeys(dups + top))
    for i in np.linspace(0, n_q - 1, DOMAIN_CHECK_ROWS).astype(int):
        if len(rows) >= DOMAIN_CHECK_ROWS:
            break
        if int(i) not in rows:
            rows.append(int(i))
    return torch.tensor(rows, device=m["table"].device)


def domain_map_checks(torch, knn2, m, queries, plants, pred, rad_q, n_sm):
    """K2a over the map `m` (``domain_map``), unguided and at xy_mode 1
    and 2: the DOMAIN_CHECK_ROWS rows of ``domain_check_rows`` bit-exact
    against ``plain_chunked``; the boundary duplicates' lower row with
    d_second == d_best == 0; unguided, every strong pair match (at most
    DOMAIN_STRONG bits between the query and a left-image descriptor)
    found again at a copy of that descriptor at the same distance. Launches
    per call, the kernel's device ms and the bound per launch. Returns
    (record, failures)."""
    (q, _), (p, _) = queries, plants
    table, valid, pts2 = m["table"], m["valid"], m["pts2"]
    n_q, n_rows, words = q.shape[0], table.shape[0], m["words"]
    label = f"knn2 {n_q} x {n_rows} x {words}w"
    ones = torch.ones(p.shape[0], dtype=torch.bool, device=q.device)
    pair_d, _, pair_idx = knn2.knn2(q, p, ones)
    strong = pair_d <= DOMAIN_STRONG
    strong[:len(m["bounds"])] = False
    rows = domain_check_rows(torch, m, strong, pair_idx, n_q)
    cap = knn2.max_columns(knn2.kernel_words(words))
    rec = {"shape": [n_q, n_rows, 32 * words], "strong": int(strong.sum()),
           "check_rows": len(rows), "bounds": m["bounds"]}
    fails = []
    for mode in (0, 1, 2):
        r2 = rad_q if mode == 1 else m["rad_c"]
        args = (q, table, valid) + ((pred, r2, pts2) if mode else ())
        fn = functools.partial(knn2.knn2, *args, xy_mode=mode)
        got = fn()
        want = plain_chunked(torch, knn2, q[rows], table, valid,
                             pred[rows] if mode else None,
                             r2[rows] if mode == 1 else r2, pts2, mode)
        for name, a, b in zip(("d_best", "d_second", "idx"), got, want):
            if not torch.equal(a[rows], b):
                fails.append(f"{label} xy_mode={mode}: {name} differs from "
                             f"the chunked plain search in "
                             f"{int((a[rows] != b).sum())} of {len(rows)} "
                             "rows")
        for j, b in enumerate(m["bounds"]):
            if (int(got[2][j]) != b - 1 or float(got[0][j]) != 0.0
                    or float(got[1][j]) != 0.0):
                fails.append(f"{label} xy_mode={mode}: the duplicates at "
                             f"rows {b - 1}, {b}: "
                             f"{[float(x[j]) for x in got]}")
        if mode == 0:
            d_map, idx_map = got[0][strong], got[2][strong].long()
            back = (d_map == pair_d[strong]) & torch.all(
                table[idx_map.clamp(min=0)]
                == p[pair_idx[strong].long()], dim=1) & (idx_map >= 0)
            rec["strong_back"] = int(back.sum())
            if not bool(back.all()):
                fails.append(f"{label}: {int((~back).sum())} of "
                             f"{int(strong.sum())} planted matches not found")
        launches = [min(cap, n_rows - c0) for c0 in range(0, n_rows, cap)]
        dev_ms, per_call = _device_profile(torch, fn, iters=3, name="knn2")
        rec[mode] = {
            "launches_per_call": _launches("knn2", fn),
            "ms": _cuda_ms(torch, fn, iters=3, warm=1),
            "kernels_per_call": per_call, "device_ms": dev_ms,
            "bound_ms_per_launch": [k2a_bound(n_q, c, words, mode > 0,
                                              n_sm)[0] for c in launches],
            "bound_by": k2a_bound(n_q, launches[0], words, mode > 0,
                                  n_sm)[1]}
        if rec[mode]["launches_per_call"] != len(launches):
            fails.append(f"{label} xy_mode={mode}: "
                         f"{rec[mode]['launches_per_call']} launches, "
                         f"{len(launches)} expected")
    rec["bound_ms"] = sum(rec[0]["bound_ms_per_launch"])
    return rec, fails


def domain_wide(torch, knn2, dev, seed, n_sm):
    """K2a at DOMAIN_WIDE_WORDS (its runtime-width kernel): bit-exact at
    2048 x 2048 on random words with ~10% invalid columns, planted ties
    and gates (``knn2_inputs``), at ``KNN2_RAGGED``, on the extreme pairs
    of each width's key; and on 16-byte-unaligned (one word off)
    contiguous views at 8 and 24 words. Device ms and the bound at 2048 x
    2048 per width. Returns {words: record}."""
    rng = np.random.default_rng(seed + 121)
    n = 2048

    def words(rows, w):
        return torch.from_numpy(rng.integers(-2**31, 2**31, (rows, w),
                                             dtype=np.int64)
                                .astype(np.int32)).to(dev)

    def xy():
        return torch.from_numpy(np.stack(
            [rng.uniform(0, WIDTH, n), rng.uniform(0, HEIGHT, n)], axis=1)
            .astype(np.float32)).to(dev)

    recs = {}
    for w in DOMAIN_WIDE_WORDS:
        cases = knn2_inputs(torch, rng, words(n, w), words(n, w), xy(), xy(),
                            dev)
        err = check_knn2(torch, knn2, cases)
        check_knn2_ragged(torch, knn2, knn2_ragged_cases(
            torch, np.random.default_rng(seed + 122 + w), dev, w))
        check_knn2_extreme(torch, knn2, knn2_extreme_cases(torch, dev, w))
        fn = functools.partial(knn2.knn2, *cases[0])
        rec = {"shape": [n, n, 32 * w], "max_abs_err": err,
               "launches_per_call": _launches("knn2", fn),
               "ms": _cuda_ms(torch, fn)}
        rec["device_ms"], rec["kernels_per_call"] = _device_profile(
            torch, fn, name="knn2")
        rec["bound_ms"], rec["bound_by"] = k2a_bound(n, n, w, False, n_sm)
        recs[w] = rec
    for w in (8, 24):
        flat = words(2 * n * w + 1, 1).reshape(-1)
        a = flat[1:n * w + 1].view(n, w)
        b = flat[n * w + 1:].view(n, w)
        if a.data_ptr() % 16 == 0 or not a.is_contiguous():
            raise AssertionError("the unaligned view is aligned")
        valid = torch.from_numpy(rng.random(n) > 0.1).to(dev)
        for name, g, e in zip(("d_best", "d_second", "idx"),
                              knn2.knn2(a, b, valid),
                              knn2.knn2_plain(a, b, valid)):
            if not torch.equal(g, e):
                raise AssertionError(f"knn2 unaligned {w} words: {name} "
                                     "differs from the plain version")
        recs[f"unaligned_{w}w"] = "bit-exact"
    return recs


def domain_l2(torch, knn2, dev, seed, n_sm):
    """K2b at DOMAIN_L2_DEPTHS (D > 640: the streamed query tile; D = 641
    takes 4-byte copies): at 2048 x 2048 on random unit rows with planted
    duplicates and gated rows (``knn2_l2_inputs``, ``check_knn2_l2``), at
    ``KNN2_L2_RAGGED`` (``check_knn2_l2_ragged``), and at D = 1024 with
    the wrapper's column chunk cut to DOMAIN_L2_CHUNK (3 launches merged
    by ``merge_top2``). Device ms, kernels per call and the bound per
    depth. Returns ({depth: record}, max abs err)."""
    rng = np.random.default_rng(seed + 123)
    n = 2048

    def unit(depth):
        x = rng.normal(size=(n, depth)).astype(np.float32)
        return torch.from_numpy(x / np.linalg.norm(x, axis=1,
                                                   keepdims=True)).to(dev)

    def xy():
        return torch.from_numpy(np.stack(
            [rng.uniform(0, WIDTH, n), rng.uniform(0, HEIGHT, n)], axis=1)
            .astype(np.float32)).to(dev)

    recs, err = {}, check_knn2_l2_ragged(torch, knn2, knn2_l2_ragged_cases(
        torch, np.random.default_rng(seed + 124), dev,
        depths=DOMAIN_L2_DEPTHS))
    for depth in DOMAIN_L2_DEPTHS:
        cases, planted, gated = knn2_l2_inputs(torch, rng, unit(depth),
                                               unit(depth), xy(), xy(), dev)
        err = max(err, check_knn2_l2(torch, knn2, cases, planted, gated))
        rec = {"shape": [n, n, depth]}
        for m in (0, 1):
            fn = functools.partial(knn2.knn2_l2, *cases[m], xy_mode=m)
            r = {"ms": _cuda_ms(torch, fn),
                 "plain_ms": _cuda_ms(torch, functools.partial(
                     knn2.knn2_l2_plain, *cases[m], xy_mode=m)),
                 "launches_per_call": _launches("knn2_l2", fn)}
            r["device_ms"], r["kernels_per_call"] = _device_profile(torch,
                                                                    fn)
            r["bound_ms"], r["bound_by"] = k2b_bound(n, n, depth, m > 0,
                                                     n_sm)
            if r["launches_per_call"] != 1:
                raise AssertionError(f"knn2_l2 D={depth}: "
                                     f"{r['launches_per_call']} launches per "
                                     "call, not 1")
            rec[m] = r
        recs[depth] = rec
        if depth == 1024:
            keep = knn2.L2_MAX_COLUMNS
            knn2.L2_MAX_COLUMNS = DOMAIN_L2_CHUNK
            try:
                err = max(err, check_knn2_l2(torch, knn2, cases, planted,
                                             gated))
                rec["chunked_launches_per_call"] = _launches(
                    "knn2_l2", functools.partial(knn2.knn2_l2, *cases[0]))
            finally:
                knn2.L2_MAX_COLUMNS = keep
    return recs, err


def _sharded_reference(torch, knn2, q, table, vq, valid, binary, ratio):
    """What ``sharded_match`` over a world of one is held to: the plain
    search of every query against the whole map (binary: chunk by chunk
    of DOMAIN_PLAIN_COLS columns, blocks of DOMAIN_PLAIN_ROWS queries),
    the JAX package's merge rule for one shard (an invalid query (1e9,
    1e9, 0), column -1 -> 0) and the cross-check on the best rows' plain
    reverse search."""
    plain = knn2.knn2_plain if binary else knn2.knn2_l2_plain
    parts = []
    for r0 in range(0, q.shape[0], DOMAIN_PLAIN_ROWS):
        qs = q[r0:r0 + DOMAIN_PLAIN_ROWS]
        parts.append(plain_chunked(torch, knn2, qs, table, valid) if binary
                     else plain(qs, table, valid))
    d1, d2, idx = (torch.cat(x) for x in zip(*parts))
    d1 = torch.where(vq, d1, knn2.BIG)
    d2 = torch.where(vq, d2, knn2.BIG)
    best = torch.where(vq, idx.clamp(min=0), 0)
    _, _, rev = plain(table[best.long()], q, vq)
    keep = (vq & (d1 < knn2.BIG * 0.5) & (d1 < ratio * d2)
            & (rev.clamp(min=0) == torch.arange(q.shape[0],
                                                device=q.device)))
    return {"idx": best, "distance": d1, "second_distance": d2,
            "mask": keep}


def _unit_rows(torch, g, rows, depth, dev):
    """Seeded non-negative unit rows (SIFT-like) on the card."""
    x = torch.abs(torch.randn((rows, depth), generator=g, device=dev))
    return x / torch.linalg.norm(x, dim=1, keepdim=True)


def domain_sharded(torch, knn2, m, queries, plants, dev, seed):
    """``sharded_match`` in a world of one over NCCL (mesh 1 x 1, in this
    process): the scene's right-image descriptors against the binary map
    `m` (``domain_map``), every field of every row equal to
    ``_sharded_reference``, the strong pair matches found again at their
    distance; and 2048 x DOMAIN_FLOAT_MAP seeded non-negative unit rows
    (half of the queries planted with 0.005 noise) within DIST_FLOAT_TOL
    (1 + |d|), idx and mask equal where no near tie decides them, the
    planted queries matched to their rows. ~5% of the queries invalid.
    ms per call (DOMAIN_TIMED_RUNS after a warm one, host clock ending in
    a sync) and launches per call. Returns (record, failures)."""
    import datetime

    import torch.distributed as dist

    from matchinglib_poselib_torch.config import LOWE_RATIO
    from matchinglib_poselib_torch.parallel import mesh as pmesh
    from matchinglib_poselib_torch.parallel.matching import sharded_match

    (q, _), (p, _) = queries, plants
    g = torch.Generator(device=dev).manual_seed(seed + 125)
    n_q = q.shape[0]
    vq = torch.rand(n_q, generator=g, device=dev) >= DOMAIN_INVALID
    fmap = _unit_rows(torch, g, *DOMAIN_FLOAT_MAP, dev)
    fq = _unit_rows(torch, g, n_q, DOMAIN_FLOAT_MAP[1], dev)
    planted = torch.arange(n_q // 2, device=dev)
    frows = torch.linspace(0, DOMAIN_FLOAT_MAP[0] - 1, len(planted),
                           device=dev).long()
    noisy = torch.abs(fq[planted] + 0.005 * torch.randn(
        fq[planted].shape, generator=g, device=dev))
    fmap[frows] = noisy / torch.linalg.norm(noisy, dim=1, keepdim=True)
    fvalid = torch.ones(DOMAIN_FLOAT_MAP[0], dtype=torch.bool, device=dev)
    ones = torch.ones(p.shape[0], dtype=torch.bool, device=dev)
    pair_d, _, _ = knn2.knn2(q, p, ones)
    strong = (pair_d <= DOMAIN_STRONG) & vq
    strong[:len(m["bounds"])] = False

    torch.cuda.set_device(dev)
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=DIST_RANK_TIMEOUT_S))
    rec, fails = {}, []
    try:
        mesh = pmesh.make_mesh(1, device=dev)
        calls = {
            "binary": (functools.partial(sharded_match, mesh, q, m["table"],
                                         vq, m["valid"]),
                       (q, m["table"], m["valid"], True)),
            "float": (functools.partial(sharded_match, mesh, fq, fmap, vq,
                                        fvalid, binary=False),
                      (fq, fmap, fvalid, False))}
        for kind, (fn, (qq, table, valid, binary)) in calls.items():
            kernel = "knn2" if binary else "knn2_l2"
            res = fn()
            got = {k: getattr(res, k) for k in DIST_MATCH_FIELDS}
            ref = _sharded_reference(torch, knn2, qq, table, vq, valid,
                                     binary, LOWE_RATIO)
            label = f"sharded_match {kind} {n_q} x {tuple(table.shape)}"
            if binary:
                for k in DIST_MATCH_FIELDS:
                    if not torch.equal(got[k], ref[k].to(got[k].dtype)):
                        fails.append(f"{label}: {k} differs from the chunked "
                                     "plain search in "
                                     f"{int((got[k] != ref[k]).sum())} rows")
                back = got["distance"][strong] == pair_d[strong]
                rec["strong_back"] = [int(back.sum()), int(strong.sum())]
                if not bool(back.all()):
                    fails.append(f"{label}: planted matches not found")
            else:
                d, s = ref["distance"], ref["second_distance"]
                tol = DIST_FLOAT_TOL * (1.0 + d.abs())
                for k in ("distance", "second_distance"):
                    if bool(((got[k] - ref[k]).abs() > tol).any()):
                        fails.append(f"{label}: {k} off the plain search")
                clear = (vq & (s - d > tol)
                         & ((d - LOWE_RATIO * s).abs() > tol))
                for k in ("idx", "mask"):
                    if not torch.equal(got[k][clear], ref[k][clear]):
                        fails.append(f"{label}: {k} differs from the plain "
                                     "search away from near ties")
                pv = planted[vq[planted]]
                back = got["idx"][pv] == frows[vq[planted]]
                rec["planted_back"] = [int(back.sum()), len(pv)]
                if not bool(back.all()):
                    fails.append(f"{label}: planted rows not found")
            r = {"shape": [n_q, table.shape[0], table.shape[1]
                           * (32 if binary else 1)],
                 "launches_per_call": _launches(kernel, fn)}
            ms = []
            for _ in range(DOMAIN_TIMED_RUNS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            r["ms"], r["ms_median"] = ms, float(np.median(ms))
            r["kernel_device_ms"], r["kernels_per_call"] = _device_profile(
                torch, fn, iters=3, name="knn2")
            rec[kind] = r
    finally:
        dist.destroy_process_group()
    return rec, fails


def domains_phase(torch, fast_nms, knn2, features, cfg, det, desc, i1, i2,
                  dev, seed, n_sm):
    """Phase 12: K1 at t < 0 (``domain_k1``); K2a against the maps of
    DOMAIN_MAPS (``domain_map``, ``domain_map_checks``: the scene's 2048
    right-image ORB descriptors, or BRISK's at 16 words, against seeded
    maps holding the left image's), at DOMAIN_WIDE_WORDS and on
    unaligned views (``domain_wide``); K2b past D = 640 (``domain_l2``);
    ``sharded_match`` in a world of one against the largest 8-word map and
    a float map (``domain_sharded``). Returns (record, failures, wall
    s)."""
    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed + 126)
    out, fails = {}, []
    scene = (i1[None].contiguous(), torch.stack([i1, i2]).contiguous())
    out["k1"], f = domain_k1(torch, fast_nms, scene, dev, seed, n_sm)
    fails += f
    bands = features.detector_bands(det)
    kp1, kp2 = (features.detect_keypoints(i, det) for i in (i1, i2))
    descs = {}
    for kind in (desc, cfg.DescriptorConfig(kind="BRISK")):
        d1, _ = features.compute_descriptors(i1, kp1, kind, bands)
        d2, _ = features.compute_descriptors(i2, kp2, kind, bands)
        descs[d1.shape[1]] = ((d2, kp2.xy), (d1, kp1.xy))
    n_q = kp2.xy.shape[0]
    pred = kp2.xy + torch.from_numpy(rng.normal(
        scale=8.0, size=(n_q, 2)).astype(np.float32)).to(dev)
    rad_q = torch.from_numpy(
        (rng.uniform(20, 80, n_q) ** 2).astype(np.float32)).to(dev)
    out["maps"] = {}
    sharded_map = None
    for i, (words, n_rows) in enumerate(DOMAIN_MAPS):
        queries, plants = descs[words]
        m = domain_map(torch, knn2, n_rows, queries, plants, pred,
                       seed + 127 + i, dev)
        rec, f = domain_map_checks(torch, knn2, m, queries, plants, pred,
                                   rad_q, n_sm)
        out["maps"][f"{n_rows}x{words}w"] = rec
        fails += f
        if (words, n_rows) == DOMAIN_SHARDED_MAP:
            sharded_map = m
        del m
        torch.cuda.empty_cache()
    out["wide"] = domain_wide(torch, knn2, dev, seed, n_sm)
    out["l2"], out["l2_max_abs_err"] = domain_l2(torch, knn2, dev, seed,
                                                 n_sm)
    out["sharded"], f = domain_sharded(torch, knn2, sharded_map, *descs[8],
                                       dev, seed)
    fails += f
    return out, fails, time.perf_counter() - t_phase


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

    det, desc, match, pose_cfg = flagship_configs(cfg)
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
    try:
        fast_nms.fast_nms_score(one, thr, fast_nms.MAX_RADIUS + 1)
    except ValueError:
        pass
    else:
        raise AssertionError("fast_nms: radius "
                             f"{fast_nms.MAX_RADIUS + 1} on the card did not "
                             "raise")
    # a negative threshold takes its own instantiation: bit-exact
    neg_err, neg_ties = check_fast_nms(torch, fast_nms, one, -thr,
                                       det.nms_radius)
    if neg_err or neg_ties:
        raise AssertionError(f"fast_nms t={-thr}: max abs err {neg_err}, "
                             f"{neg_ties} tie mismatches")
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

    for b_i, (b_name, change, bars) in enumerate(pose_menu(cfg,
                                                           pose_cfg.robust)):
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
    # 4e. the matching menu: subpix + VFC, the SOF filter
    match_steps, fails = match_phase(torch, cfg, det, desc, match, pose_cfg,
                                     ((img1, img2), (i1, i2)), Kt, dist,
                                     (R_true, t_true), args.seed)
    failures.extend(fails)
    match_launches = {m_name: rec["launches"] for m_name, rec in match_steps}
    steps.extend(
        (f"FAST t=12 / 2048 kp / ORB / {m_name} / 96x12 5pt USAC", rec)
        for m_name, rec in match_steps)
    # 6. the stream: StereoRefine on the card, fed by the front end
    stream_rec, fails, stream_frames = stream_phase(
        torch, cfg, det, desc, match, dev, args.seed)
    failures.extend(f"stream: {f}" for f in fails)
    steps.append(("stream: poselib-test --stereoRef defaults (pool 30000) /"
                  " FAST t=12 / 2048 kp / ORB / GMBSOF", stream_rec))
    # 7. the batch: run_batch on the sequence's first 8 pairs
    batch_rec, fails, batch_out = batch_phase(torch, det, desc, match,
                                              pose_cfg, dev, args.seed)
    failures.extend(f"batch: {f}" for f in fails)
    steps.append((f"batch of {BATCH_PAIRS} (render_sequence frames 1-"
                  f"{BATCH_PAIRS}): FAST t=12 / 2048 kp / ORB / GMBSOF / "
                  "96x12 5pt USAC", batch_rec))
    # 7b. the batch with the matching and robust options together
    opt_match = match_menu(cfg, match)[0][1]
    opt_pose = dataclasses.replace(pose_cfg, robust=dataclasses.replace(
        pose_cfg.robust, estimator=cfg.PoseEstimator.LMEDS,
        solver=cfg.MinimalSolver.STEWENIUS_5PT))
    opt_rec, fails = batch_options_phase(torch, det, desc, opt_match,
                                         opt_pose, dev, args.seed)
    failures.extend(f"batch with options: {f}" for f in fails)
    steps.append((f"batch of {BATCH_OPTION_PAIRS} (render_sequence frames "
                  f"1-{BATCH_OPTION_PAIRS}): FAST t=12 / 2048 kp / ORB / "
                  "GMBSOF + subpix + VFC / 96x12 5pt LMEDS, Stewenius",
                  opt_rec))
    # 7c. run_batch with each pose branch of phase 4d's menu
    branch_recs, fails, branch_s = branch_batch_phase(
        torch, cfg, det, desc, match, pose_cfg, dev, args.seed, smi)
    failures.extend(f"batch {f}" for f in fails)
    for b_name, rec in branch_recs.items():
        print(json.dumps({"batch_branch": b_name, **{
            k: rec[k] for k in ("card", "pairs", "ms_mean", "ms_median",
                                "pairs_one_by_one_ms", "host_syncs_per_batch",
                                "profiled_batch", "branch_s")}}))
    print(json.dumps({"phase_7c_s": branch_s}))
    steps.extend(
        (f"batch of {BRANCH_BATCH_PAIRS} (render_sequence frames 1-"
         f"{BRANCH_BATCH_PAIRS}): FAST t=12 / 2048 kp / ORB / GMBSOF / "
         f"96x12 5pt USAC / pose {b_name}", rec)
        for b_name, rec in branch_recs.items())
    # 8. the three CLIs on files
    apps_rec, fails = apps_phase(torch, dev, args.seed, smi)
    failures.extend(f"apps: {f}" for f in fails)
    steps.append((f"apps: poselib-test, --stereoRef, matchinglib-test on "
                  f"render_sequence frames 1-{APP_FRAMES} as PNGs; "
                  "noMatch_poselib-test on eval/fixtures/semireal_fs",
                  apps_rec))
    apps_launches = apps_rec["launches_per_frame"]
    # 9. the rest of the front end: K2a at 2, 4 and 16 words and K2b at the
    # float rows' depths, then every detector and descriptor row
    t_phase9 = time.perf_counter()
    k2a16, k2a16_cases = frontend_kernel_checks(torch, knn2, features, cfg,
                                                det, i1, i2, args.seed)
    fe_rows, fe_extra, fails = frontend_phase(
        torch, cfg, match, pose_cfg, ((img1, img2), (i1, i2)), Kt, dist,
        (R_true, t_true), dev, args.seed, smi)
    failures.extend(f"frontend: {f}" for f in fails)
    for name, rec in fe_rows.items():
        print(json.dumps({"frontend": name, **{
            k: rec.get(k) for k in (
                "card", "runs", "ms_mean", "ms_median", "stages_ms",
                "launches", "cpu_agree", "n_corr", "n_inliers",
                "rot_err_deg", "t_err_deg", "profiled_run")}}))
    print(json.dumps({"frontend_batch": fe_extra["batch"],
                      "frontend_cli": fe_extra["matchinglib_test_akaze"],
                      "card": smi}))
    print(json.dumps({"phase_9_s": time.perf_counter() - t_phase9,
                      "card": smi}))
    # 10. the library layer: K2b at D = 2 and 3, the estimators, LK flow
    # with LKOF / ALKOF, the node, entry(), the example and trace()
    k2b_d2 = library_kernel_checks(torch, knn2, args.seed, dev, n_sm)
    lib, fails, lib_s = library_phase(torch, dev, args.seed, det, desc,
                                      match, pose_cfg.robust)
    failures.extend(fails)
    for row, rec in lib["estimators"].items():
        print(json.dumps({"library": row, "card": smi, **rec}))
    for row in ("lk_flow", "flow_frames_1_2", "match_lkof", "match_alkof",
                "k2b_d2_coords"):
        print(json.dumps({"library": row, "card": smi, **lib["flow"][row]}))
    for row in ("node", "node_stereoRef", "entry", "example"):
        print(json.dumps({"library": row, "card": smi, **lib["apps"][row]}))
    print(json.dumps({"phase_10_s": lib_s, "card": smi, **{
        k: lib[k] for k in ("estimators_s", "flow_s", "apps_s")}}))
    # 11. distribution: worlds of ranks on the card(s), each rank a process
    dist_recs, fails, dist_s = distribution_phase(
        torch, cfg, sift, dev, args.seed, smi, stream_frames, batch_out)
    failures.extend(fails)
    dist_out, dist_launches = dist_lines(dist_recs, smi, n_sm)
    for line in dist_out:
        print(json.dumps(line))
    print(json.dumps({"phase_11_s": dist_s, "card": smi}))
    # 12. the kernels over the JAX package's whole input domain: K1 at
    # t < 0, K2a past one launch's columns and past 16 words, unaligned,
    # K2b past D = 640, sharded_match against a 2^24-row map on one card
    dom, fails, dom_s = domains_phase(torch, fast_nms, knn2, features, cfg,
                                      det, desc, i1, i2, dev, args.seed,
                                      n_sm)
    failures.extend(f"domains: {f}" for f in fails)
    for part in ("k1", "maps", "wide", "l2", "sharded"):
        print(json.dumps({"domains": part, "card": smi, "record": dom[part]}))
    print(json.dumps({"phase_12_s": dom_s, "card": smi}))

    def launches_distribution(name):
        return {w: {fn: v[name] for fn, v in fns.items()}
                for w, fns in dist_launches.items()}

    def lib_launches(name):
        apps = lib["apps"]
        out = {row: apps[row]["launches"][name]
               for row in ("node", "node_stereoRef", "entry", "example")}
        for row in ("match_lkof", "match_alkof"):
            out[row] = lib["flow"][row]["launches"][name]
        return out
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
    # K2a at 512 bits (phase 9's ring descriptors): twice the words, two
    # tensor-core products per tile, the same epilogue per pair
    n1w, n2w = k2a16_cases[0][0].shape[0], k2a16_cases[0][1].shape[0]
    pairs16 = n1w * n2w
    k2_16_bytes = (n1w + n2w) * 64 + n2w + n1w * 12
    k2_16_popc = _bound(k2_16_bytes,
                        pairs16 * 16 / (POPC_PER_CLK_SM * sm_clk_s))
    k2_16_tc = _bound(k2_16_bytes, pairs16 / sm_clk_s * max(
        2 * 512 / BMMA_OPS_PER_CLK_SM, KNN2_INT_OPS[0] / INT32_PER_CLK_SM))
    k2_16_bound = min(k2_16_popc, k2_16_tc)

    def fe_launches(name):
        return {row: rec["launches"][name] for row, rec in fe_rows.items()}

    def fe_batch_launches(name):
        return {row: rec["launches"][name]
                for row, rec in fe_extra["batch"].items()}
    kernels_line = {"kernels": [
        {"name": "fast_nms", "route": "cuda",
         "source": "matchinglib_poselib_torch/csrc/fast_nms.cu",
         "replaces": "matchinglib_poselib_tpu/ops/pallas/fast.py:113",
         "launches": launches["fast_nms"],
         "max_abs_err": max(k1_err,
                            batch_rec["k1_batch_stack"]["max_abs_err"]),
         "launches_stream": stream_rec["launches"]["fast_nms"],
         "launches_batch": batch_rec["launches"]["fast_nms"],
         "launches_match_menu": {k: v["fast_nms"]
                                 for k, v in match_launches.items()},
         "launches_batch_options": opt_rec["launches"]["fast_nms"],
         "launches_batch_branches": {k: v["launches"]["fast_nms"]
                                     for k, v in branch_recs.items()},
         "launches_apps": {k: v["fast_nms"] for k, v in apps_launches.items()},
         "launches_frontend": fe_launches("fast_nms"),
         "launches_frontend_batch": fe_batch_launches("fast_nms"),
         "launches_frontend_cli":
             fe_extra["matchinglib_test_akaze"]["launches"]["fast_nms"],
         "launches_library": lib_launches("fast_nms"),
         "launches_distribution": launches_distribution("fast_nms"),
         "ms": k1_ms, "plain_ms": k1_plain_ms,
         "bound_ms": k1_bound[0], "bound_by": k1_bound[1],
         "bound_pipe": k1_pipe if k1_bound[1] == "operations" else "memory",
         "bound_pipes_ms": {k: v * 1e3 for k, v in k1_pipes.items()},
         "library_ms": None, "tie_mismatches": k1_ties,
         "all_cases_max_abs_err": k1_pad_err,
         "pyramid_levels_checked": k2a16["k1_levels"],
         "all_cases_tie_mismatches": k1_pad_ties,
         "kernels_per_call": k1_per_call,
         "device_ms": k1_dev_ms, "plain_device_ms": k1_plain_dev_ms,
         "domains": {"threshold_below_0": {
             k: dom["k1"][k] for k in (
                 "shape", "threshold", "radius", "launches_per_call",
                 "kernels_per_call", "device_ms", "ms", "plain_ms",
                 "bound_ms", "bound_by", "bound_pipe")}}},
        {"name": "knn2", "route": "cuda",
         "source": "matchinglib_poselib_torch/csrc/knn2.cu",
         "replaces": "matchinglib_poselib_tpu/ops/pallas/knn.py:131",
         "launches": launches["knn2"], "max_abs_err": k2_err,
         "launches_stream": stream_rec["launches"]["knn2"],
         "launches_batch": batch_rec["launches"]["knn2"],
         "launches_match_menu": {k: v["knn2"]
                                 for k, v in match_launches.items()},
         "launches_batch_options": opt_rec["launches"]["knn2"],
         "launches_batch_branches": {k: v["launches"]["knn2"]
                                     for k, v in branch_recs.items()},
         "launches_apps": {k: v["knn2"] for k, v in apps_launches.items()},
         "launches_frontend": fe_launches("knn2"),
         "launches_frontend_batch": fe_batch_launches("knn2"),
         "launches_frontend_cli":
             fe_extra["matchinglib_test_akaze"]["launches"]["knn2"],
         "launches_library": lib_launches("knn2"),
         "launches_distribution": launches_distribution("knn2"),
         "max_abs_err_16w": k2a16["max_abs_err"],
         "shape_16w": k2a16["shape"],
         "ms_16w": k2a16["ms"], "plain_ms_16w": k2a16["plain_ms"],
         "device_ms_16w": k2a16["device_ms"],
         "plain_device_ms_16w": k2a16["plain_device_ms"],
         "ms_16w_guided": k2a16["ms_guided"],
         "plain_ms_16w_guided": k2a16["plain_ms_guided"],
         "device_ms_16w_guided": k2a16["device_ms_guided"],
         "bound_ms_16w": k2_16_bound[0], "bound_by_16w": k2_16_bound[1],
         "bound_route_16w": "tensor cores" if k2_16_bound is k2_16_tc
         else "popc",
         "ms": k2_ms[0], "plain_ms": k2_plain_ms[0],
         "bound_ms": k2_bound[0], "bound_by": k2_bound[1],
         "bound_route": "tensor cores" if k2_bound is k2_tc else "popc",
         "bound_popc_ms": k2_popc[0],
         "bound_ms_guided": min(k2_popc, k2_tc_guided)[0],
         "library_ms": None,
         "device_ms": k2_dev_ms[0], "plain_device_ms": k2_plain_dev_ms[0],
         "ms_guided": k2_ms[1], "plain_ms_guided": k2_plain_ms[1],
         "device_ms_guided": k2_dev_ms[1],
         "plain_device_ms_guided": k2_plain_dev_ms[1],
         "domains": {
             "maps": {k: {"shape": v["shape"], **{
                 f"xy_mode_{m}": v[m] for m in (0, 1, 2)}}
                 for k, v in dom["maps"].items()},
             "wide": {str(k): v for k, v in dom["wide"].items()},
             "sharded_match_binary": dom["sharded"]["binary"]}},
        {"name": "knn2_l2", "route": "cuda",
         "source": "matchinglib_poselib_torch/csrc/knn2_l2.cu",
         "replaces": "matchinglib_poselib_tpu/ops/pallas/knn.py:51",
         "launches": sift_launches["knn2_l2"],
         "max_abs_err": max(k2b_err, k2a16["k2b_max_abs_err"],
                            k2b_d2["max_abs_err_ragged"]),
         "launches_batch": batch_rec["launches"]["knn2_l2"],
         "launches_match_menu": {k: v["knn2_l2"]
                                 for k, v in match_launches.items()},
         "launches_batch_options": opt_rec["launches"]["knn2_l2"],
         "launches_batch_branches": {k: v["launches"]["knn2_l2"]
                                     for k, v in branch_recs.items()},
         "launches_apps": {k: v["knn2_l2"] for k, v in apps_launches.items()},
         "launches_frontend": fe_launches("knn2_l2"),
         "launches_frontend_batch": fe_batch_launches("knn2_l2"),
         "launches_library": lib_launches("knn2_l2"),
         "launches_distribution": launches_distribution("knn2_l2"),
         "d2": {**k2b_d2, "lk_coordinates": lib["flow"]["k2b_d2_coords"]},
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
         "by_shape": k2b,
         "domains": {
             "depths": {str(d): {"shape": v["shape"], "unguided": v[0],
                                 "guided": v[1], **({
                                     "chunked_launches_per_call":
                                     v["chunked_launches_per_call"]}
                                     if "chunked_launches_per_call" in v
                                     else {})}
                        for d, v in dom["l2"].items()},
             "max_abs_err": dom["l2_max_abs_err"],
             "sharded_match_float": dom["sharded"]["float"]}},
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
