"""Halign (multi-plane homography pose): port vs JAX package.

The port draws the JAX package's own plane streams
(test_torch_helpers.jax_plane_uniforms). Tolerances: the four
decomposition candidates agree as a set (the two SVDs may order singular
pairs by other signs, which permutes the candidates), each entry within
1e-4; plane masks and validity equal slot for slot; error codes equal;
a successful pose within 0.01 deg (rotation, chordal: the trace form
saturates at ~0.05-0.1 deg for f32 rotations) and 0.05 deg (translation
direction), its inlier mask on >= 99.5% of slots — the tolerances of
tests/test_torch_robust.py. The two-plane scene of
tests/test_pose_branches.py claims too little of its points at the tight
membership threshold (error -2 on both sides); the same scene at 0.2 px
noise and 5% outliers exercises the successful path.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from matchinglib_poselib_tpu import config as jcfg
from matchinglib_poselib_tpu.ops import homography_pose as jhp

from matchinglib_poselib_torch import config as tcfg
from matchinglib_poselib_torch.ops import homography_pose as thp

from conftest import random_pose, synthetic_correspondences
from test_pose_branches import F, _pixel_correspondences
from test_torch_helpers import (
    dir_angle_deg, jax_plane_uniforms, n, rot_angle_deg, rot_chordal_deg, t,
)

ROB = dict(batch_hypotheses=64, max_batches=4)
TH_SQ = np.float32((0.8 / F) ** 2)


def _h_from_pose(R, tt, normal, d):
    return (R + np.outer(tt, normal) / d).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_decompose_homography_candidate_sets_match(seed):
    rng = np.random.default_rng(seed)
    R, tt = random_pose(rng, 20.0)
    normal = rng.normal(size=3)
    normal = normal / np.linalg.norm(normal) * np.sign(normal[2])
    Hs = np.stack([_h_from_pose(R, tt, normal, rng.uniform(3.0, 10.0)),
                   R.astype(np.float32)])  # a plane and a pure rotation
    for H, planar in zip(Hs * rng.uniform(0.5, 2.0), (True, False)):
        dj = jhp.decompose_homography(jnp.asarray(H))
        dt = thp.decompose_homography(t(H))
        assert n(dt.valid).all() and np.asarray(dj.valid).all()
        # a pure rotation has t = 0 and no defined normal: R and t only
        parts_j = [np.asarray(dj.R).reshape(4, 9), np.asarray(dj.t)]
        parts_t = [n(dt.R).reshape(4, 9), n(dt.t)]
        if planar:
            parts_j.append(np.asarray(dj.n))
            parts_t.append(n(dt.n))
        else:
            assert not n(dt.t).any()
        cj = np.concatenate(parts_j, axis=1)
        ct = np.concatenate(parts_t, axis=1)
        # set equality: every candidate of either side has its match
        d = np.abs(cj[:, None, :] - ct[None, :, :]).max(-1)
        assert d.min(1).max() < 1e-4 and d.min(0).max() < 1e-4, d
    # the planted pose is among the candidates
    dt = thp.decompose_homography(t(Hs[0]))
    errs = [rot_angle_deg(R, n(dt.R)[i]) + dir_angle_deg(tt, n(dt.t)[i])
            for i in range(4)]
    assert min(errs) < 1e-2


def _normalized(pts1, pts2):
    c = np.array([320.0, 240.0])
    return ((pts1 - c) / F).astype(np.float32), ((pts2 - c) / F).astype(
        np.float32)


def _run_both(x1, x2, mask, q, key):
    jcfg_h, tcfg_h = jcfg.HalignConfig(), tcfg.HalignConfig()
    rj = jhp.estimate_pose_halign(
        jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(mask), jnp.asarray(q),
        jcfg_h, jcfg.RobustConfig(**ROB), key,
        threshold_sq=jnp.asarray(TH_SQ))
    rt = thp.estimate_pose_halign(
        t(x1), t(x2), torch.from_numpy(mask), t(q), tcfg_h,
        tcfg.RobustConfig(**ROB), threshold_sq=torch.tensor(TH_SQ),
        plane_uniforms=jax_plane_uniforms(key, tcfg_h.max_planes,
                                          ROB["max_batches"],
                                          ROB["batch_hypotheses"]))
    return rj, rt


def test_multiple_homographies_same_planes():
    _, _, pts1, pts2, mask, q = _pixel_correspondences(planar=True,
                                                       outlier_frac=0.15)
    x1, x2 = _normalized(pts1, pts2)
    key = jax.random.PRNGKey(11)
    Hj, mj, vj = jhp.estimate_multiple_homographies(
        jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(mask), jnp.asarray(q),
        jcfg.HalignConfig(), jcfg.RobustConfig(**ROB), key,
        jnp.asarray(TH_SQ))
    Ht, mt, vt = thp.estimate_multiple_homographies(
        t(x1), t(x2), torch.from_numpy(mask), t(q), tcfg.HalignConfig(),
        tcfg.RobustConfig(**ROB), torch.tensor(TH_SQ),
        plane_uniforms=jax_plane_uniforms(key, 3, ROB["max_batches"],
                                          ROB["batch_hypotheses"]))
    np.testing.assert_array_equal(n(vt), np.asarray(vj))
    np.testing.assert_array_equal(n(mt), np.asarray(mj))
    assert int(n(vt).sum()) >= 2
    for a, b, ok in zip(n(Ht), np.asarray(Hj), n(vt)):
        if ok:
            a, b = a / np.linalg.norm(a), b / np.linalg.norm(b)
            assert min(np.abs(a - b).max(), np.abs(a + b).max()) < 1e-3


@pytest.mark.parametrize("noise,outliers,code", [(0.4, 0.15, -2),
                                                 (0.2, 0.05, 0)])
def test_halign_pose_two_plane_scene(noise, outliers, code):
    R, tt, pts1, pts2, mask, q = _pixel_correspondences(
        planar=True, noise_px=noise, outlier_frac=outliers)
    x1, x2 = _normalized(pts1, pts2)
    rj, rt = _run_both(x1, x2, mask, q, jax.random.PRNGKey(11))
    assert int(rj.error_code) == code
    assert int(rt.error_code) == int(rj.error_code)
    np.testing.assert_array_equal(n(rt.plane_valid),
                                  np.asarray(rj.plane_valid))
    np.testing.assert_allclose(n(rt.plane_strengths),
                               np.asarray(rj.plane_strengths), atol=1e-6)
    if int(rj.error_code) == 0:
        assert rot_chordal_deg(np.asarray(rj.R), n(rt.R)) < 0.01
        assert dir_angle_deg(np.asarray(rj.t), n(rt.t)) < 0.05
        agree = (n(rt.inlier_mask) == np.asarray(rj.inlier_mask)).mean()
        assert agree >= 0.995
        assert rot_angle_deg(R, n(rt.R)) < 3.0
        assert dir_angle_deg(tt, n(rt.t)) < 10.0


def test_halign_reports_failure_on_a_general_scene():
    """A non-planar scene is no plane-dominated scene: an error code, the
    same on both sides."""
    rng = np.random.default_rng(5)
    R, tt = random_pose(rng, 12.0)
    x1, x2 = synthetic_correspondences(rng, R, tt, 300, noise=0.4 / F,
                                       outlier_frac=0.2)
    x1, x2 = x1.astype(np.float32), x2.astype(np.float32)
    mask = np.ones(300, bool)
    q = rng.uniform(0.3, 1.0, 300).astype(np.float32)
    rj, rt = _run_both(x1, x2, mask, q, jax.random.PRNGKey(3))
    assert int(rj.error_code) != 0
    assert int(rt.error_code) == int(rj.error_code)
    np.testing.assert_array_equal(n(rt.plane_valid),
                                  np.asarray(rj.plane_valid))
    assert rt.error_code.dtype == torch.int32
