"""Entry points: the flagship step on one stereo pair through
``get_correspondences`` and ``estimate_pose`` (the PyTorch counterpart of
``__graft_entry__.entry``), and the multi-rank dryrun (of
``__graft_entry__.dryrun_multichip``).

    fn, args = entry()            # card tensors; entry(device="cpu")
    R, t, n_inliers, n_matches = fn(*args)

    # in every rank of a world the caller started
    # (torch.distributed.init_process_group)
    res = dryrun_multichip()      # the card; dryrun_multichip(device="cpu")
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from matchinglib_poselib_torch.apps import common
from matchinglib_poselib_torch.config import (
    DescriptorConfig,
    DetectorConfig,
    MatchingConfig,
    PoseConfig,
    RobustConfig,
)
from matchinglib_poselib_torch.models import pipeline

# the flagship step's shapes (__graft_entry__.py:46-47)
HEIGHT, WIDTH, MAX_KEYPOINTS, HYPOTHESES = 384, 512, 1024, 256


def flagship_step(max_keypoints: int = MAX_KEYPOINTS,
                  hypotheses: int = HYPOTHESES):
    """The flagship step: FAST t=12 at `max_keypoints` slots, ORB, GMBSOF,
    then the default pose stage at `hypotheses` x 4 batches. Returns
    step(img1, img2, K1, K2, dist1, dist2, generator) -> (R, t,
    n_inliers, n_matches)."""
    det = DetectorConfig(kind="FAST", max_keypoints=max_keypoints,
                         fast_threshold=12.0)
    desc = DescriptorConfig(kind="ORB")
    match = MatchingConfig(matcher_name="GMBSOF")
    pose = PoseConfig(robust=RobustConfig(batch_hypotheses=hypotheses,
                                          max_batches=4))

    def step(img1, img2, K1, K2, dist1, dist2, generator):
        corr = pipeline.get_correspondences(img1, img2, det, desc, match)
        res = pipeline.estimate_pose(
            corr.pts1, corr.pts2, corr.mask, corr.quality, K1, K2, dist1,
            dist2, pose, generator=generator)
        return res.R, res.t, res.n_inliers, corr.n

    return step


def entry(device: torch.device | str = "cuda"):
    """(fn, example_args) of the flagship step on `device` (the card
    unless the caller passes ``device="cpu"``; no card: RuntimeError):
    two seeded random 384 x 512 images, a 500 px pinhole K, no
    distortion, and a ``torch.Generator`` seeded 0."""
    device = common.cli_device(device, "entry")
    rng = np.random.default_rng(0)
    img1 = common.to_device(rng.random((HEIGHT, WIDTH)), device)
    img2 = common.to_device(rng.random((HEIGHT, WIDTH)), device)
    K = common.to_device([[500.0, 0.0, WIDTH / 2], [0.0, 500.0, HEIGHT / 2],
                          [0.0, 0.0, 1.0]], device)
    dist = torch.zeros(5, dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    return flagship_step(), (img1, img2, K, K, dist, dist, gen)


# the dryrun's shapes (__graft_entry__.py:91-92): 64 x 96 images, 128
# slots, 64 hypotheses x 4 batches, 2 pairs per pairs rank
DRYRUN_HEIGHT, DRYRUN_WIDTH = 64, 96
DRYRUN_KEYPOINTS, DRYRUN_HYPOTHESES = 128, 64
DRYRUN_PAIRS_PER_RANK = 2


def dryrun_pipeline(device: torch.device | str = "cuda"):
    """The dryrun's pairs-parallel step: the flagship configs at
    ``DRYRUN_KEYPOINTS`` slots and ``DRYRUN_HYPOTHESES`` x 4 batches."""
    det = DetectorConfig(kind="FAST", max_keypoints=DRYRUN_KEYPOINTS,
                         fast_threshold=12.0)
    pose = PoseConfig(robust=RobustConfig(batch_hypotheses=DRYRUN_HYPOTHESES,
                                          max_batches=4))
    return pipeline.StereoPipeline(det, DescriptorConfig(kind="ORB"),
                                   MatchingConfig(matcher_name="GMBSOF"),
                                   pose, device=device)


def dryrun_batch(pairs: int, seed: int = 0):
    """The dryrun's batch of `pairs` pairs, on the CPU: (rng, imgs1, imgs2
    (pairs, H, W) seeded random images, K (a 100 px pinhole), uniforms,
    degen_uniforms), the streams drawn pair after pair from one CPU
    generator seeded `seed`, so that any block of the pairs can run on its
    own with its pairs' streams. `rng` goes on to make the dryrun's other
    inputs."""
    from matchinglib_poselib_torch.ops import robust

    rng = np.random.default_rng(seed)
    shape = (pairs, DRYRUN_HEIGHT, DRYRUN_WIDTH)
    imgs1 = torch.as_tensor(rng.random(shape), dtype=torch.float32)
    imgs2 = torch.as_tensor(rng.random(shape), dtype=torch.float32)
    W, H = DRYRUN_WIDTH, DRYRUN_HEIGHT
    K = torch.tensor([[100.0, 0.0, W / 2], [0.0, 100.0, H / 2],
                      [0.0, 0.0, 1.0]])
    e_shape, d_shape = robust.sample_shapes(
        dryrun_pipeline("cpu").pose_cfg.robust)
    g = torch.Generator().manual_seed(seed)
    drawn = [(torch.rand(e_shape, generator=g),
              torch.rand(d_shape, generator=g)) for _ in range(pairs)]
    return (rng, imgs1, imgs2, K, torch.stack([u for u, _ in drawn]),
            torch.stack([d for _, d in drawn]))


class DryrunResult(NamedTuple):
    mesh_shape: tuple[int, int]  # (pairs, db)
    # the pairs-parallel step, gathered over the pairs axis
    R: torch.Tensor  # (B, 3, 3)
    t: torch.Tensor  # (B, 3)
    n_inliers: torch.Tensor  # (B,)
    n_matches: torch.Tensor  # (B,)
    match_mask: torch.Tensor  # (B, DRYRUN_KEYPOINTS) bool
    inlier_mask: torch.Tensor  # (B, DRYRUN_KEYPOINTS) bool
    knn_db_rows: int
    knn_matched: int
    ba_rot_deg: float  # sharded BA's camera 1 against the planted pose
    ba_vs_single: float  # max |sharded - single-rank| over R and t
    consensus_rot_deg: float
    consensus_t_deg: float
    consensus_wsum: float


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"dryrun_multichip: {what}")


def dryrun_multichip(mesh=None, device: torch.device | str = "cuda"
                     ) -> DryrunResult:
    """One sharded step of every distributed path, run inside every rank
    of a world the caller started, each with a content assertion:

    1. the pairs-parallel flagship step: B = 2 x the pairs size pairs of
       seeded random 64 x 96 images, each pairs rank its contiguous block
       through ``StereoPipeline.run_batch`` with its pairs' explicit
       streams (``dryrun_batch``); R gathered to (B, 3, 3);
    2. pod-wide kNN on a db of 128 rows per db rank sharded over ``db``:
       64 planted queries each match their own db row at distance 0;
    3. point-sharded BA (64 points, 2 cameras, 8 iterations): the
       perturbed camera comes back within 0.05 deg of the planted pose,
       and agrees with single-rank ``bundle_adjust`` to 5e-5;
    4. the frame-window consensus over 2 frames per pairs rank: within 0.3
       / 0.5 deg of the planted pose, the weights' sum within 1.

    `mesh`: a ("pairs", "db") mesh (``parallel.mesh.make_mesh``), else
    one is made over the world on `device` (the card unless the caller
    asks for the CPU; no card: RuntimeError). Prints the
    ``dryrun_multichip ok`` line; raises AssertionError on a failed
    check."""
    from matchinglib_poselib_torch.ops import ba as ba_ops, geometry as geo
    from matchinglib_poselib_torch.parallel import mesh as pmesh
    from matchinglib_poselib_torch.parallel import stream
    from matchinglib_poselib_torch.parallel.ba import bundle_adjust_sharded
    from matchinglib_poselib_torch.parallel.matching import sharded_match

    if mesh is None:
        device = common.cli_device(device, "dryrun_multichip")
        mesh = pmesh.make_mesh(device=device)
    device = torch.device(mesh.device_type)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    n_pairs = pmesh.axis_size(mesh, pmesh.PAIRS_AXIS)
    n_db = pmesh.axis_size(mesh, pmesh.DB_AXIS)

    # 1. the pairs-parallel step: this rank's block of the batch
    B = DRYRUN_PAIRS_PER_RANK * n_pairs
    rng, imgs1, imgs2, K, uni, degen = dryrun_batch(B)
    pipe = dryrun_pipeline(device)
    corr, pose = pipe.run_batch(
        *(pmesh.pairs_block(mesh, x) for x in (imgs1, imgs2)), K, K,
        torch.zeros(5), torch.zeros(5),
        uniforms=pmesh.pairs_block(mesh, uni).to(device),
        degen_uniforms=pmesh.pairs_block(mesh, degen).to(device))
    f32 = torch.float32
    packed = pmesh.gather_axis(mesh, torch.cat([
        pose.R.reshape(-1, 9), pose.t, pose.n_inliers.to(f32)[:, None],
        corr.n.to(f32)[:, None], corr.mask.to(f32),
        pose.inlier_mask.to(f32)], dim=1), pmesh.PAIRS_AXIS).cpu()
    kp = DRYRUN_KEYPOINTS
    R = packed[:, :9].reshape(B, 3, 3)
    _require(R.shape == (B, 3, 3), f"R {tuple(R.shape)}")

    # 2. pod-wide kNN: planted rows of the db as queries
    n_q, n_rows = 64, 128 * n_db
    ddb = rng.integers(0, 2**32, size=(n_rows, 8), dtype=np.uint32)
    plant = np.linspace(0, n_rows - 1, n_q).astype(np.int32)
    db = torch.as_tensor(ddb.view(np.int32), device=device)
    res = sharded_match(mesh, db[torch.as_tensor(plant, device=device)],
                        pmesh.db_block(mesh, db),
                        torch.ones(n_q, device=device),
                        pmesh.db_block(mesh, torch.ones(n_rows, device=device)))
    n_matched = int(res.mask.sum())
    _require(n_matched == n_q, f"kNN matched {n_matched} of {n_q}")
    _require(bool((res.idx.cpu() == torch.as_tensor(plant)).all()),
             "wrong kNN indices")
    _require(bool((torch.where(res.mask, res.distance, 0.0) == 0.0).all()),
             "planted kNN distances not 0")

    # 3. point-sharded BA against the planted pose and a single rank
    cth, sth = math.cos(0.02), math.sin(0.02)
    R_gt = np.asarray([[cth, 0.0, sth], [0.0, 1.0, 0.0], [-sth, 0.0, cth]])
    t_gt = np.asarray([1.0, 0.05, 0.02])
    t_gt = t_gt / np.linalg.norm(t_gt)
    n_pts, n_cams = 64, 2
    X = np.stack([rng.uniform(-2, 2, n_pts), rng.uniform(-2, 2, n_pts),
                  rng.uniform(4, 10, n_pts)], axis=1)
    Rc = np.stack([np.eye(3), R_gt])
    tc = np.stack([np.zeros(3), t_gt])
    obs = np.zeros((n_pts, n_cams, 2))
    for c in range(n_cams):
        Xc = X @ Rc[c].T + tc[c]
        obs[:, c] = Xc[:, :2] / Xc[:, 2:3]
    obs += rng.normal(scale=1e-4, size=obs.shape)
    Rp = Rc.copy()
    jit = np.deg2rad(0.5)
    Rp[1] = (np.eye(3) + np.array([[0, -jit, 0], [jit, 0, 0], [0, 0, 0]])
             ) @ Rc[1]
    u, _, vt = np.linalg.svd(Rp[1])
    Rp[1] = u @ vt

    def on(a):
        return torch.as_tensor(np.asarray(a), dtype=f32, device=device)

    args = (on(obs), on(np.ones((n_pts, n_cams))), on(Rp), on(tc),
            on(np.stack([np.eye(3)] * n_cams)), on(np.zeros((n_cams, 5))),
            on(X), on([0.0, 1.0]))
    res_d = bundle_adjust_sharded(mesh, *args, iterations=8)
    rd_ba = float(geo.compare_poses(res_d.R[1], res_d.t[1], on(Rc[1]),
                                    on(tc[1]))[0])
    _require(rd_ba < 0.05, f"sharded BA rot residual {rd_ba}")
    res_1 = ba_ops.bundle_adjust(*args, iterations=8)
    ba_diff = max(float((res_d.R - res_1.R).abs().max()),
                  float((res_d.t - res_1.t).abs().max()))
    _require(ba_diff <= 5e-5, f"sharded BA cameras != single rank "
             f"({ba_diff})")

    # 4. the frame-window consensus over per-frame poses
    Rs, ts, ws = [], [], []
    for _ in range(2 * n_pairs):
        ang = rng.normal(scale=2e-3)
        ca, sa = np.cos(ang), np.sin(ang)
        Rs.append(np.asarray([[ca, -sa, 0.0], [sa, ca, 0.0],
                              [0.0, 0.0, 1.0]]) @ R_gt)
        ts.append(t_gt + rng.normal(scale=1e-3, size=3))
        ws.append(rng.uniform(50, 200))
    R_ml, t_ml, wsum = stream.windowed_pose_consensus(
        mesh, *(stream.frame_window_block(mesh, on(np.stack(a)))
                for a in (Rs, ts, ws)))
    rd_s, td_s, _ = geo.compare_poses(R_ml, t_ml, on(R_gt), on(t_gt))
    rd_s, td_s, wsum = float(rd_s), float(td_s), float(wsum)
    _require(rd_s < 0.3, f"stream consensus R off by {rd_s} deg")
    _require(td_s < 0.5, f"stream consensus t off by {td_s} deg")
    _require(abs(wsum - sum(ws)) < 1.0, f"consensus weights {wsum}")

    shape = (n_pairs, n_db)
    print(f"dryrun_multichip ok: mesh={dict(zip(mesh.mesh_dim_names, shape))}"
          f" pairs_batch={B} knn_db={n_rows} matches={n_matched}/{n_q} "
          f"planted-idx exact; sharded BA == single-device (5e-5, "
          f"rd={rd_ba:.5f} deg); stream consensus rd={rd_s:.4f} deg vs "
          "planted")
    return DryrunResult(
        mesh_shape=shape, R=R, t=packed[:, 9:12],
        n_inliers=packed[:, 12].to(torch.int32),
        n_matches=packed[:, 13].to(torch.int32),
        match_mask=packed[:, 14:14 + kp] > 0.5,
        inlier_mask=packed[:, 14 + kp:] > 0.5, knn_db_rows=n_rows,
        knn_matched=n_matched, ba_rot_deg=rd_ba, ba_vs_single=ba_diff,
        consensus_rot_deg=rd_s, consensus_t_deg=td_s, consensus_wsum=wsum)
