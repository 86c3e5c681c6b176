"""Robust estimation and refinement: port vs JAX package.

The port draws the JAX package's own uniforms (computed here with
jax.random and injected), so both engines evaluate the same samples.
Tolerances: inlier masks agree on >= 99.5% of slots and recovered poses
within 0.01 deg (rotation) and 0.05 deg (translation direction) — the
models differ only by f32 rounding of the solver and refit chains, which
moves a residual across the threshold for at most a slot or two. The
round-5 regression fixtures of tests/test_robust_regressions.py run on
the port unchanged.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from matchinglib_poselib_tpu import config as jcfg
from matchinglib_poselib_tpu.ops import geometry as jg, refine as jr
from matchinglib_poselib_tpu.ops import robust as jrob

from matchinglib_poselib_torch import config as tcfg
from matchinglib_poselib_torch.ops import geometry as tg, refine as trf
from matchinglib_poselib_torch.ops import robust as trob

from conftest import random_pose, synthetic_correspondences
from test_torch_helpers import (
    dir_angle_deg, jax_degen_uniforms, jax_uniforms, n, rot_angle_deg, t,
)

TH = 3e-3  # ~2 sigma of the Sampson residual at noise 1e-3


def _scene(seed, n_pts=256, noise=1e-3, outlier_frac=0.3):
    rng = np.random.default_rng(seed)
    R, tt = random_pose(rng, 12.0)
    x1, x2 = synthetic_correspondences(rng, R, tt, n_pts, noise=noise,
                                       outlier_frac=outlier_frac)
    quality = rng.uniform(0.0, 1.0, n_pts).astype(np.float32)
    return x1.astype(np.float32), x2.astype(np.float32), quality


def _poses_close(Ej, Et, x1, x2, inl_j, inl_t):
    mj = jnp.asarray(np.asarray(inl_j), jnp.float32)
    Rj, tj, _, _, _ = jg.recover_pose(jnp.asarray(np.asarray(Ej)),
                                      jnp.asarray(x1), jnp.asarray(x2), mj)
    Rt, tt, _, _, _ = tg.recover_pose(Et, t(x1), t(x2), inl_t.float())
    return rot_angle_deg(np.asarray(Rj), n(Rt)), dir_angle_deg(
        np.asarray(tj), n(tt))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_estimate_essential_robust_with_jax_uniforms(seed):
    x1, x2, q = _scene(seed)
    cfg = dict(batch_hypotheses=64, max_batches=4, threshold_px=TH)
    key = jax.random.PRNGKey(seed)
    mask = np.ones(len(x1), np.float32)
    prior = 0.5
    rj, dj = jrob.estimate_essential_robust(
        jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(mask), jnp.asarray(q),
        jcfg.RobustConfig(**cfg), key, threshold_sq=TH * TH,
        prior_inlier_ratio=prior)
    rt, dt = trob.estimate_essential_robust(
        t(x1), t(x2), t(mask), t(q), tcfg.RobustConfig(**cfg),
        threshold_sq=TH * TH, prior_inlier_ratio=prior,
        uniforms=jax_uniforms(key, 4, 64, 5),
        degen_uniforms=jax_degen_uniforms(key, 64))
    assert int(rt.n_batches) == int(rj.n_batches)
    agree = (n(rt.inlier_mask) == np.asarray(rj.inlier_mask)).mean()
    assert agree >= 0.995, agree
    assert abs(int(rt.n_inliers) - int(rj.n_inliers)) <= 2
    dr, dtr = _poses_close(rj.model, rt.model, x1, x2, rj.inlier_mask,
                           rt.inlier_mask)
    assert dr < 0.01 and dtr < 0.05, (dr, dtr)
    assert bool(dt.is_degenerate) == bool(dj.is_degenerate)
    assert abs(float(dt.h_fraction) - float(dj.h_fraction)) < 0.02


def test_sample_without_replacement_same_indices():
    key = jax.random.PRNGKey(3)
    pools = np.array([5, 7, 9, 40, 256, 256, 100, 6], np.int32)
    ref = np.asarray(jrob.sample_without_replacement(
        key, jnp.asarray(pools), 5, 256))
    u = torch.from_numpy(np.array(jax.random.uniform(key, (8, 5))))
    out = n(trob.sample_without_replacement(u, torch.from_numpy(pools), 5,
                                            256))
    np.testing.assert_array_equal(out, ref)
    for row, p in zip(out, pools):
        assert len(set(row)) == 5 and row.max() < p
    for i in range(12):
        np.testing.assert_array_equal(
            n(trob.prosac_pool_schedule(i, torch.tensor(180), 5, 12)),
            np.asarray(jrob.prosac_pool_schedule(
                jnp.asarray(i), jnp.asarray(180), 5, 12)))


def _project(x1, R, tt, depth):
    X = np.concatenate([x1 * depth[:, None], depth[:, None]], axis=1)
    X2 = X @ R.T + tt
    return X2[:, :2] / X2[:, 2:3]


def test_port_biased_quality_prefix_does_not_certify_early_stop():
    """Port of the round-5 regression: the 60 best-quality slots follow a
    coherent decoy pose; the port must find the ~360-point majority."""
    rng = np.random.default_rng(5)
    R_true, t_true = random_pose(rng, max_angle_deg=8.0)
    R_bad, t_bad = random_pose(rng, max_angle_deg=25.0)
    n_all, n_bad = 420, 60
    x1 = np.stack([rng.uniform(-0.4, 0.4, n_all),
                   rng.uniform(-0.3, 0.3, n_all)], axis=1)
    depth = rng.uniform(4.0, 12.0, n_all)
    x2 = _project(x1, R_true, t_true, depth)
    x2[:n_bad] = _project(x1[:n_bad], R_bad, t_bad, depth[:n_bad])
    noise = 0.4 / 800.0
    x1 += rng.normal(scale=noise, size=x1.shape)
    x2 += rng.normal(scale=noise, size=x2.shape)
    quality = np.full(n_all, 0.2, np.float32)
    quality[:n_bad] = 0.9
    th = 1.2 / 800.0
    cfg = tcfg.RobustConfig(batch_hypotheses=96, max_batches=12,
                            threshold_px=th)
    res, _ = trob.estimate_essential_robust(
        t(x1), t(x2), torch.ones(n_all), t(quality), cfg,
        threshold_sq=th * th,
        uniforms=jax_uniforms(jax.random.PRNGKey(7), 12, 96, 5),
        degen_uniforms=jax_degen_uniforms(jax.random.PRNGKey(7), 96))
    assert int(res.n_inliers) > 250
    err = tg.sampson_error(res.model, t(x1), t(x2))
    assert abs(int(torch.sum(err < res.threshold)) - int(res.n_inliers)) <= 2


def test_port_lo_guard_never_loses_support_vs_ransac_winner():
    for seed in range(4):
        rng = np.random.default_rng(seed)
        R, tt = random_pose(rng, max_angle_deg=12.0)
        x1, x2 = synthetic_correspondences(
            rng, R, tt, 300, noise=0.5 / 800.0, outlier_frac=0.3)
        th = 0.8 / 800.0
        gen = torch.Generator().manual_seed(100 + seed)
        u = trob.draw_uniforms(gen, (4, 128, 5), "cpu")
        du = trob.draw_uniforms(gen, (1, 64, 4), "cpu")
        results = []
        for lo in (False, True):
            cfg = tcfg.RobustConfig(batch_hypotheses=128, max_batches=4,
                                    threshold_px=th, lo_refine=lo)
            r, _ = trob.estimate_essential_robust(
                t(x1), t(x2), torch.ones(len(x1)), None, cfg,
                threshold_sq=th * th, uniforms=u, degen_uniforms=du)
            results.append(int(r.n_inliers))
        assert results[1] >= results[0], (seed, results)


def _refine_setup(seed=11, n_pts=400):
    rng = np.random.default_rng(seed)
    R, tt = random_pose(rng, max_angle_deg=10.0)
    x1, x2 = synthetic_correspondences(
        rng, R, tt, n_pts, noise=0.4 / 800.0, outlier_frac=0.2)
    E0 = np.cross(np.eye(3), tt / np.linalg.norm(tt)) @ R
    return (x1.astype(np.float32), x2.astype(np.float32),
            E0.astype(np.float32), R, tt)


def test_refine_essential_linear_matches():
    x1, x2, E0, R, tt = _refine_setup()
    th_sq = np.float32((0.8 / 800.0) ** 2)
    mask = np.ones(len(x1), np.float32)
    for cap in (None, 256):
        jc = jcfg.RefinementConfig(refine_max_points=cap)
        tc = tcfg.RefinementConfig(refine_max_points=cap)
        rj = jr.refine_essential_linear(
            jnp.asarray(E0), jnp.asarray(x1), jnp.asarray(x2),
            jnp.asarray(mask), jnp.asarray(th_sq), jc)
        rt = trf.refine_essential_linear(t(E0), t(x1), t(x2), t(mask),
                                         torch.tensor(th_sq), tc)
        agree = (n(rt.inlier_mask) == np.asarray(rj.inlier_mask)).mean()
        assert agree >= 0.995
        dr, dtr = _poses_close(rj.model, rt.model, x1, x2, rj.inlier_mask,
                               rt.inlier_mask)
        assert dr < 0.01 and dtr < 0.05, (cap, dr, dtr)
    # the port's own drift-guard property (regression fixture)
    s = np.linalg.svd(n(rt.model).astype(np.float64), compute_uv=False)
    assert s[2] < 1e-4 * s[0] and abs(s[0] - s[1]) < 1e-3 * s[0]


def test_polish_pose_iterative_matches():
    x1, x2, E0, R, tt = _refine_setup(seed=13)
    th_sq = np.float32((0.8 / 800.0) ** 2)
    Rj, tj, _, okj, _ = jg.recover_pose(
        jnp.asarray(E0), jnp.asarray(x1), jnp.asarray(x2),
        jnp.ones(len(x1), jnp.float32))
    err = np.asarray(jg.sampson_error(jnp.asarray(E0), jnp.asarray(x1),
                                      jnp.asarray(x2)))
    inl = (err < th_sq).astype(np.float32)
    valid = np.ones(len(x1), np.float32)
    kw = dict(rounds=3, iterations=6, max_points=256)
    pj, ij = jr.polish_pose_iterative(
        Rj, tj, jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(inl),
        jnp.asarray(valid), jnp.asarray(th_sq), **kw)
    pt, it = trf.polish_pose_iterative(
        t(np.asarray(Rj)), t(np.asarray(tj)), t(x1), t(x2), t(inl), t(valid),
        torch.tensor(th_sq), **kw)
    assert rot_angle_deg(np.asarray(pj.R), n(pt.R)) < 0.01
    assert dir_angle_deg(np.asarray(pj.t), n(pt.t)) < 0.05
    assert (n(it) == np.asarray(ij)).mean() >= 0.995
    assert rot_angle_deg(R, n(pt.R)) < 0.2


def test_rotation_only_model_and_degeneracy_flags_plane():
    """A single plane is degenerate for E: both packages flag it."""
    rng = np.random.default_rng(21)
    R, tt = random_pose(rng, 10.0)
    x1 = rng.uniform(-0.4, 0.4, (200, 2))
    depth = 6.0 + 0.5 * x1[:, 0]  # points on one plane
    x2 = _project(x1, R, tt, depth)
    x1, x2 = x1.astype(np.float32), x2.astype(np.float32)
    w = np.ones(200, np.float32)
    np.testing.assert_allclose(
        n(trob.rotation_only_model(t(x1), t(x2), t(w))),
        np.asarray(jrob.rotation_only_model(jnp.asarray(x1), jnp.asarray(x2),
                                            jnp.asarray(w))), atol=1e-5)
    th = 1.0 / 800.0
    cfg = dict(batch_hypotheses=64, max_batches=2, threshold_px=th)
    key = jax.random.PRNGKey(4)
    _, dj = jrob.estimate_essential_robust(
        jnp.asarray(x1), jnp.asarray(x2), jnp.ones(200), None,
        jcfg.RobustConfig(**cfg), key, threshold_sq=th * th)
    _, dt = trob.estimate_essential_robust(
        t(x1), t(x2), torch.ones(200), None, tcfg.RobustConfig(**cfg),
        threshold_sq=th * th, uniforms=jax_uniforms(key, 2, 64, 5),
        degen_uniforms=jax_degen_uniforms(key, 64))
    assert bool(dj.is_degenerate) and bool(dt.is_degenerate)
