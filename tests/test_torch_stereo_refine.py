"""Streaming framework (``models/stereo_refine.py``): port vs JAX package.

Both ``StereoRefine`` classes take the same seeded stream of pixel
correspondences; the port draws the JAX package's own uniforms
(``test_torch_helpers.jax_stereo_refine_streams``), so both robust
engines evaluate the same samples. Per frame the state and the skip
count must be equal, R within 0.1 deg (chordal) and t within 0.5 deg.

Two quantities are compared with a stated allowance in the free-running
stream, because the JAX package decides them on f32 rounding noise:

- the pool size, within 1%. Right after a pool is seeded (init, reinit),
  the JAX package's Sampson history holds the same error twice, computed
  once eagerly and once inside a jitted update, which round differently
  in the last ulp; the dedup's "increasing error" preference then keeps
  or drops a new point in the 5-20% weight band on that noise (48 of 218
  seeded slots read as increasing in one stream). The port evaluates
  both the same way. Started from the JAX package's own state every
  frame (``tests/test_torch_checkpoint.py``), the pool sizes are equal.
- the stability flags, equal except where a ranking rating sits within
  the two packages' rating difference of the band's edge: the ratings
  are distances normalized by the spread of the pose history, so once
  the history converges, 0.001 deg of pose difference moves them by a
  few hundredths. Such a flip is reported with its rating and band.
"""

import numpy as np
import pytest
import torch

from matchinglib_poselib_tpu.config import (
    BAConfig, PoseConfig, RobustConfig, StereoRefineConfig,
)
from matchinglib_poselib_tpu.models.stereo_refine import (
    StereoRefine as JaxStereoRefine,
)

from matchinglib_poselib_torch import convert
from matchinglib_poselib_torch.models.stereo_refine import StereoRefine

from conftest import random_pose
from test_torch_helpers import (
    dir_angle_deg, jax_stereo_refine_streams, rot_chordal_deg,
)

K_CAM = np.array([[600.0, 0, 320.0], [0, 600.0, 240.0], [0, 0, 1.0]])
POOL_CAP = 1024
ROT_DEG, T_DEG = 0.1, 0.5
POOL_RTOL = 0.01


def make_cfg(**changes):
    return StereoRefineConfig(
        max_pool_correspondences=POOL_CAP,
        pose=PoseConfig(robust=RobustConfig(batch_hypotheses=128,
                                            max_batches=3)),
        **changes,
    )


def gen_frame(rng, R, t, n=256, noise_px=0.2, outlier_frac=0.15):
    """One frame of pixel correspondences of the rig (R, t)."""
    X = np.stack([rng.uniform(-2.0, 2.0, n), rng.uniform(-1.5, 1.5, n),
                  rng.uniform(4.0, 12.0, n)], axis=1)
    x1 = X[:, :2] / X[:, 2:3]
    X2 = X @ R.T + t
    x2 = X2[:, :2] / X2[:, 2:3]
    p1 = x1 @ K_CAM[:2, :2].T + K_CAM[:2, 2]
    p2 = x2 @ K_CAM[:2, :2].T + K_CAM[:2, 2]
    p1 += rng.normal(scale=noise_px, size=p1.shape)
    p2 += rng.normal(scale=noise_px, size=p2.shape)
    n_out = int(outlier_frac * n)
    if n_out:
        idx = rng.choice(n, n_out, replace=False)
        p2[idx] = rng.uniform([0, 0], [640, 480], size=(n_out, 2))
    quality = rng.uniform(0.0, 1.0, n).astype(np.float32)
    desc = rng.uniform(0.0, 80.0, n).astype(np.float32)
    return p1.astype(np.float32), p2.astype(np.float32), quality, desc


def garbage_frame(rng, n=256):
    p1 = rng.uniform([0, 0], [640, 480], size=(n, 2)).astype(np.float32)
    p2 = rng.uniform([0, 0], [640, 480], size=(n, 2)).astype(np.float32)
    return p1, p2, np.ones(n, np.float32), np.zeros(n, np.float32)


def stream(seed):
    """16 frames: a clean start (5), a garbage frame, 2 clean frames, then
    the rig moves for good (8 frames of a pose > 10 deg away)."""
    rng = np.random.default_rng(seed)
    R, t = random_pose(rng, 10.0)
    R2, t2 = random_pose(rng, 25.0)
    while rot_chordal_deg(R, R2) < 10.0:
        R2, t2 = random_pose(rng, 25.0)
    frames = [gen_frame(rng, R, t) for _ in range(5)]
    frames.append(garbage_frame(rng))
    frames += [gen_frame(rng, R, t) for _ in range(2)]
    frames += [gen_frame(rng, R2, t2, outlier_frac=0.05) for _ in range(8)]
    return frames


def both(cfg, seed=3, min_pool_size_stable=300):
    js = JaxStereoRefine(K_CAM, K_CAM, cfg=cfg, seed=seed)
    ts = StereoRefine(K_CAM, K_CAM, cfg=convert.config_from_jax(cfg),
                      device="cpu",
                      streams=jax_stereo_refine_streams(seed, cfg))
    js.min_pool_size_stable = ts.min_pool_size_stable = min_pool_size_stable
    return js, ts


def feed(sr, frame):
    p1, p2, quality, desc = frame
    return sr.add_new_correspondences(p1, p2, quality=quality,
                                      desc_dist=desc)


def ranking_near_tie(js, ts, cfg):
    """Why the two packages' stability flags may differ: the smallest
    distance of a JAX rating in the ranking window to the edge of its band
    (last +- abs_th_ranking_stable, min_norm_dist_stable), and the largest
    rating difference between the packages in that window."""
    jr, tr = np.asarray(js.pose_ratings), np.asarray(ts.pose_ratings)
    m = cfg.min_cont_stable_poses
    if len(jr) != len(tr) or len(jr) < m:
        return None
    win = slice(len(jr) - m, len(jr))
    slack = float(np.abs(jr[win] - tr[win]).max())
    last = jr[-1]
    edges = (last - cfg.abs_th_ranking_stable,
             last + cfg.abs_th_ranking_stable, cfg.min_norm_dist_stable)
    margin = float(min(abs(r - e) for r in jr[win] for e in edges))
    return margin, slack, jr[win].round(4).tolist(), tr[win].round(4).tolist()


def check_frame(i, a, b, js, ts, cfg, flips):
    assert a.state == b.state, (i, a.state, b.state)
    assert a.skip_count == b.skip_count, (i, a.skip_count, b.skip_count)
    assert abs(a.pool_size - b.pool_size) <= POOL_RTOL * max(a.pool_size,
                                                            1), (
        i, a.pool_size, b.pool_size)
    rot = rot_chordal_deg(a.R, b.R)
    tang = dir_angle_deg(a.t, b.t)
    assert rot < ROT_DEG and tang < T_DEG, (i, a.state, rot, tang)
    for name in ("pose_is_stable", "most_likely_pose_stable"):
        if getattr(a, name) != getattr(b, name):
            tie = ranking_near_tie(js, ts, cfg)
            assert tie is not None and tie[0] <= 2 * tie[1], (
                f"frame {i}: {name} {getattr(a, name)} (JAX) vs "
                f"{getattr(b, name)} (port), not a near-tie: margin, "
                f"slack, ratings {tie}")
            flips.append((i, name, tie))


def run_stream(cfg, frames, seed=3):
    """Both packages over `frames`, checked frame by frame. Returns the
    JAX package's states and stability flags, and the near-tie flips."""
    js, ts = both(cfg, seed)
    states, stable, flips = [], [], []
    for i, frame in enumerate(frames):
        a, b = feed(js, frame), feed(ts, frame)
        check_frame(i, a, b, js, ts, cfg, flips)
        states.append(a.state)
        stable.append(a.pose_is_stable)
    return states, stable, flips


@pytest.mark.parametrize("seed", [11, 12])
def test_stream_matches_jax(seed):
    """Clean start, a garbage frame that is skipped, a persistent pose
    change that reinitializes, and the stability check reached on both
    sides of it."""
    cfg = make_cfg()
    states, stable, flips = run_stream(cfg, stream(seed))
    assert states[0] == "init"
    assert states[5] == "skipped"
    assert "reinit" in states[8:10]
    assert {"refined", "robust"} <= set(states)
    assert any(stable[:8]) and any(stable[8:])
    for f in flips:
        print("stability flip at an f32 near-tie (frame, flag, (margin, "
              "slack, JAX ratings, port ratings)):", f)


def test_port_draws_from_its_generator_without_streams():
    """Without streams the port samples from its own torch.Generator: the
    same seed gives the same frames, another seed runs too."""
    cfg = convert.config_from_jax(make_cfg())
    frames = stream(11)[:4]
    runs = []
    for seed in (5, 5, 6):
        sr = StereoRefine(K_CAM, K_CAM, cfg=cfg, seed=seed, device="cpu")
        runs.append([feed(sr, f) for f in frames])
    for a, b in zip(runs[0], runs[1]):
        assert a.state == b.state and np.array_equal(a.R, b.R)
    assert [r.state for r in runs[2]][0] == "init"
    assert all(np.isfinite(r.R).all() for r in runs[2])


@pytest.mark.parametrize("variant", ["kneip_pool", "ba_pool"])
def test_pool_path_variants_match_jax(variant):
    """Kneip instead of BA on the pool path, or BA on the pool path:
    6 frames each."""
    change = (dict(kneip_instead_ba_pool=True) if variant == "kneip_pool"
              else dict(ba_pool=BAConfig(enabled=True, iterations=8)))
    cfg = make_cfg(**change)
    rng = np.random.default_rng(21)
    R, t = random_pose(rng, 10.0)
    frames = [gen_frame(rng, R, t) for _ in range(6)]
    states, _, _ = run_stream(cfg, frames)
    assert states[0] == "init" and "refined" in states


def test_input_kinds_and_device_argument():
    """Numpy arrays and CPU tensors give the same frame; a CUDA device
    without a card raises."""
    cfg = make_cfg()
    frames = stream(11)[:2]
    out = []
    for as_tensor in (False, True):
        _, ts = both(cfg)
        for f in frames:
            f = tuple(torch.from_numpy(x) for x in f) if as_tensor else f
            r = feed(ts, f)
        out.append(r)
    assert out[0].state == out[1].state
    assert np.array_equal(out[0].R, out[1].R)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            StereoRefine(K_CAM, K_CAM, cfg=convert.config_from_jax(cfg))


def test_few_matches_switch_and_skip_escalation_match_jax():
    """useRANSAC_fewMatches and raiseSkipCnt behave as in the JAX
    package."""
    cfg = make_cfg(use_ransac_few_matches=True,
                   raise_skip_cnt=(2 << 4) | 2, max_skip_pairs=5)
    js, ts = both(cfg)
    for n in (80, 400):
        assert js._robust_cfg(n).estimator.name == ts._robust_cfg(
            n).estimator.name
        assert js._robust_cfg(n).prosac == ts._robust_cfg(n).prosac
    for k in range(5):
        js.nr_consec_stable = ts.nr_consec_stable = k
        js._update_max_skip_pairs()
        ts._update_max_skip_pairs()
        assert js.max_skip_pairs_new == ts.max_skip_pairs_new
    rng = np.random.default_rng(4)
    R, t = random_pose(rng, 10.0)
    frame = gen_frame(rng, R, t, n=80, outlier_frac=0.1)
    a, b = feed(js, frame), feed(ts, frame)
    flips = []
    check_frame(0, a, b, js, ts, cfg, flips)
    assert a.state == "init"
