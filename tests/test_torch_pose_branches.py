"""Every PoseConfig branch of estimate_pose in the port: against the JAX
package where its random streams can be replayed, and against the planted
pose everywhere.

The scene, key (PRNGKey(11)), robust config and ground-truth bars are
those of tests/test_pose_branches.py; the port draws the JAX package's own
streams (test_torch_helpers.jax_uniforms / jax_autoth_uniforms /
jax_halign_uniforms). Tolerances against the JAX package: inlier masks on
>= 99.5% of slots and poses within 0.01 deg (rotation, chordal) and
0.05 deg (translation direction) — the tolerances of
tests/test_torch_robust.py — except where the output passes through the
Kneip eigensolver, whose energy is flat at its minimum in f32 (see
tests/test_torch_eigensolver.py): 0.1 and 0.25 deg there; the Halign
error code equal. AutoTh's adapted threshold within 1e-4 relative and its
round count equal. The remaining combinations run on the port only,
against the planted pose.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from matchinglib_poselib_tpu import config as jcfg
from matchinglib_poselib_tpu.models import pipeline as jp
from matchinglib_poselib_tpu.ops import geometry as jg
from matchinglib_poselib_tpu.ops import robust as jrob

from matchinglib_poselib_torch import config as tcfg
from matchinglib_poselib_torch.convert import config_from_jax
from matchinglib_poselib_torch.models import pipeline as tp
from matchinglib_poselib_torch.ops import robust as trob

from test_pose_branches import BRANCHES, DIST, K, _pixel_correspondences
from test_torch_helpers import (
    dir_angle_deg, jax_autoth_uniforms, jax_degen_uniforms,
    jax_halign_uniforms, jax_uniforms, n, rot_angle_deg, rot_chordal_deg, t,
)

KEY = jax.random.PRNGKey(11)
KNEIP = jcfg.PoseConfig(
    robust=jcfg.RobustConfig(batch_hypotheses=192, max_batches=4),
    refine=jcfg.RefinementConfig(solver=jcfg.MinimalSolver.KNEIP))


def _streams(cfg, key):
    """The port's stream arguments for one JAX-package PoseConfig."""
    (nb, B, k), _ = trob.sample_shapes(cfg.robust)
    if cfg.use_halign:
        planes, fb = jax_halign_uniforms(key, cfg.halign.max_planes, nb, B,
                                         k)
        return dict(plane_uniforms=planes, uniforms=fb)
    if cfg.auto_th:
        u, d = jax_autoth_uniforms(key, 3, nb, B, k)
        return dict(uniforms=u, degen_uniforms=d)
    return dict(uniforms=jax_uniforms(key, nb, B, k),
                degen_uniforms=jax_degen_uniforms(key, B))


def _inputs(name):
    return _pixel_correspondences(
        planar="halign" in name,
        outlier_frac=0.15 if "halign" in name else 0.25)


def _port(cfg, pts1, pts2, mask, quality, **streams):
    return tp.estimate_pose(
        t(pts1), t(pts2), torch.from_numpy(mask), t(quality), t(K), t(K),
        t(DIST), t(DIST), config_from_jax(cfg), **streams)


def _ground_truth(name, pose, R_gt, t_gt):
    assert int(pose.n_inliers) > 100, name
    r_tol, t_tol = (3.0, 10.0) if "halign" in name else (1.0, 4.0)
    assert rot_angle_deg(R_gt, n(pose.R)) < r_tol, name
    assert dir_angle_deg(t_gt, n(pose.t)) < t_tol, name
    assert np.isfinite(n(pose.E)).all()


@pytest.mark.parametrize("name", ["auto_th", "halign", "default_ba",
                                  "kneip"])
def test_estimate_pose_branch_matches_jax(name):
    cfg = KNEIP if name == "kneip" else BRANCHES[name]
    R_gt, t_gt, pts1, pts2, mask, quality = _inputs(name)
    jpose = jp.estimate_pose(
        jnp.asarray(pts1), jnp.asarray(pts2), jnp.asarray(mask),
        jnp.asarray(quality), jnp.asarray(K), jnp.asarray(K),
        jnp.asarray(DIST), jnp.asarray(DIST), cfg, KEY)
    tpose = _port(cfg, pts1, pts2, mask, quality, **_streams(cfg, KEY))
    assert int(tpose.halign_error_code) == int(jpose.halign_error_code)
    agree = (n(tpose.inlier_mask) == np.asarray(jpose.inlier_mask)).mean()
    assert agree >= 0.995, agree
    r_tol, t_tol = (0.1, 0.25) if name == "kneip" else (0.01, 0.05)
    assert rot_chordal_deg(np.asarray(jpose.R), n(tpose.R)) < r_tol
    assert dir_angle_deg(np.asarray(jpose.t), n(tpose.t)) < t_tol
    assert bool(tpose.is_degenerate) == bool(jpose.is_degenerate)
    _ground_truth(name, tpose, R_gt, t_gt)


@pytest.mark.parametrize("name", ["auto_th_noref", "auto_th_ba",
                                  "halign_ba", "default_noref"])
def test_estimate_pose_branch_port_meets_ground_truth(name):
    cfg = BRANCHES[name]
    R_gt, t_gt, pts1, pts2, mask, quality = _inputs(name)
    pose = _port(cfg, pts1, pts2, mask, quality, **_streams(cfg, KEY))
    _ground_truth(name, pose, R_gt, t_gt)


def test_estimate_essential_autoth_matches_jax():
    """The adapted threshold, round count and latched result of AutoTh on
    the branch test's scene, in normalized coordinates."""
    cfg = BRANCHES["auto_th"]
    _, _, pts1, pts2, mask, quality = _inputs("auto_th")
    Kj = jnp.asarray(K)
    x1 = np.asarray(jg.img_to_cam(jnp.asarray(pts1), Kj))
    x2 = np.asarray(jg.img_to_cam(jnp.asarray(pts2), Kj))
    f = float(K[0, 0])
    th = cfg.robust.threshold_px / f
    kw = dict(threshold_sq=th * th, min_threshold=jcfg.MIN_PIX_TH / f,
              max_threshold=jcfg.MAX_PIX_TH / f)
    rj = jrob.estimate_essential_autoth(
        jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(mask, jnp.float32),
        jnp.asarray(quality), cfg.robust, KEY, **kw)
    rt = trob.estimate_essential_autoth(
        t(x1), t(x2), torch.from_numpy(mask).float(), t(quality),
        config_from_jax(cfg.robust), **kw, **_streams(cfg, KEY))
    assert int(rt.n_rounds) == int(rj.n_rounds)
    np.testing.assert_allclose(float(rt.threshold), float(rj.threshold),
                               rtol=1e-4)
    agree = (n(rt.result.inlier_mask)
             == np.asarray(rj.result.inlier_mask)).mean()
    assert agree >= 0.995
    assert bool(rt.degen.is_degenerate) == bool(rj.degen.is_degenerate)


def test_autoth_adapts_to_noise_in_the_port():
    """tests/test_pose_branches.py::test_auto_th_adapts_to_noise on the
    port: at 1.6 px noise AutoTh finds more support than the fixed 0.8 px
    threshold, and a usable pose."""
    from conftest import random_pose, synthetic_correspondences

    rng = np.random.default_rng(7)
    R_gt, t_gt = random_pose(rng, max_angle_deg=12.0)
    x1, x2 = synthetic_correspondences(rng, R_gt, t_gt, 400,
                                       noise=1.6 / 800.0, outlier_frac=0.15)
    c = np.array([320.0, 240.0])
    pts1 = (x1 * 800.0 + c).astype(np.float32)
    pts2 = (x2 * 800.0 + c).astype(np.float32)
    mask = np.ones(400, bool)
    quality = rng.uniform(0.3, 1.0, 400).astype(np.float32)
    rob = tcfg.RobustConfig(batch_hypotheses=192, max_batches=4)
    outs = [tp.estimate_pose(
        t(pts1), t(pts2), torch.from_numpy(mask), t(quality), t(K), t(K),
        t(DIST), t(DIST), tcfg.PoseConfig(robust=rob, auto_th=a),
        generator=torch.Generator().manual_seed(2)) for a in (False, True)]
    fixed, auto = outs
    assert int(auto.n_inliers) > int(fixed.n_inliers)
    assert rot_angle_deg(R_gt, n(auto.R)) < 1.5
    assert dir_angle_deg(t_gt, n(auto.t)) < 6.0
