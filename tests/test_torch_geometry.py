"""Geometry and closed-form linear algebra: port vs JAX package.

Tolerances: residuals, undistortion, normalization and triangulation
within rtol 1e-5 (f32 arithmetic in the same order, matrix products may
sum in another order); the closed-form 3x3 decompositions within 1e-5
(SVD/eigh sign conventions are fixed by the closed forms, and both
packages use the same ones); recovered poses within 1e-4. The rank-1
input of closest_essential_fast is left out: it is NaN in both packages.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from matchinglib_poselib_tpu.ops import geometry as jg, smalllinalg as jl

from matchinglib_poselib_torch.ops import geometry as tg, smalllinalg as tl

from conftest import random_pose, synthetic_correspondences
from test_torch_helpers import n, t


def _scene(seed=0, n_pts=64, noise=1e-3, outlier_frac=0.0):
    rng = np.random.default_rng(seed)
    R, tt = random_pose(rng, 15.0)
    x1, x2 = synthetic_correspondences(rng, R, tt, n_pts, noise=noise,
                                       outlier_frac=outlier_frac)
    return R, tt, x1.astype(np.float32), x2.astype(np.float32)


def _essentials(seed=1, count=32, scale=1e-3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        R, tt = random_pose(rng, 40.0)
        E = np.cross(np.eye(3), tt) @ R  # [t]x R
        E = E / np.linalg.norm(E) + rng.normal(scale=scale, size=(3, 3))
        out.append(E.astype(np.float32))
    return np.stack(out)


def test_sampson_and_epipolar_products():
    """rtol 1e-5 on every residual, plus atol 1e-10: a noise-level
    residual x2^T E x1 is a cancellation of O(1) terms whose last-ulp
    rounding (~1e-7 in the numerator) bounds its squared-Sampson
    agreement in absolute, not relative, terms."""
    R, tt, x1, x2 = _scene(outlier_frac=0.3)
    E = (np.cross(np.eye(3), tt) @ R).astype(np.float32)
    ref = np.asarray(jg.sampson_error(jnp.asarray(E), jnp.asarray(x1),
                                      jnp.asarray(x2)))
    out = n(tg.sampson_error(t(E), t(x1), t(x2)))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-10)
    # degenerate model scores as a gross error in both
    z = np.zeros((3, 3), np.float32)
    np.testing.assert_array_equal(
        n(tg.sampson_error(t(z), t(x1), t(x2))),
        np.asarray(jg.sampson_error(jnp.asarray(z), jnp.asarray(x1),
                                    jnp.asarray(x2))))


def test_img_to_cam_undistort_normalize():
    rng = np.random.default_rng(2)
    pts = rng.uniform(0, 480, (100, 2)).astype(np.float32)
    K = np.array([[400, 0.5, 240], [0, 390, 120], [0, 0, 1]], np.float32)
    dist = np.array([-0.2, 0.05, 1e-3, -5e-4, 0.01], np.float32)
    rc = jg.img_to_cam(jnp.asarray(pts), jnp.asarray(K))
    oc = tg.img_to_cam(t(pts), t(K))
    np.testing.assert_allclose(n(oc), np.asarray(rc), rtol=1e-5)
    ru = jg.undistort_oulu(rc, jnp.asarray(dist))
    ou = tg.undistort_oulu(oc, t(dist))
    np.testing.assert_allclose(n(ou), np.asarray(ru), rtol=1e-5, atol=1e-7)
    mask = rng.random(100) > 0.2
    rx, rT = jg.normalize_points(ru, jnp.asarray(mask))
    ox, oT = tg.normalize_points(ou, torch.from_numpy(mask))
    np.testing.assert_allclose(n(ox), np.asarray(rx), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(n(oT), np.asarray(rT), rtol=1e-5, atol=1e-6)


def test_triangulate_and_cheirality():
    R, tt, x1, x2 = _scene(3)
    Rf, tf = R.astype(np.float32), tt.astype(np.float32)
    ref = np.asarray(jg.triangulate_linear(jnp.asarray(Rf), jnp.asarray(tf),
                                           jnp.asarray(x1), jnp.asarray(x2)))
    out = n(tg.triangulate_linear(t(Rf), t(tf), t(x1), t(x2)))
    # The 3x3 normal equations amplify the last-ulp difference of their
    # products (JAX's CPU dot accumulates with FMA, torch does not) by
    # their condition number: per point |dX| / |X| <= 4 ulp * cond, which
    # is rtol 1e-5 for the well-conditioned points (cond < 40).
    P1 = np.eye(3, 4)
    P2 = np.concatenate([R, tt[:, None]], 1)
    A = np.stack([x1[:, :1] * P1[2] - P1[0], x1[:, 1:] * P1[2] - P1[1],
                  x2[:, :1] * P2[2] - P2[0], x2[:, 1:] * P2[2] - P2[1]],
                 1)[..., :3]
    cond = np.linalg.cond(np.swapaxes(A, 1, 2) @ A)
    rel = np.linalg.norm(out - ref, axis=1) / np.linalg.norm(ref, axis=1)
    assert np.all(rel <= 4 * 2.0**-24 * np.maximum(cond, 40.0)), rel / cond
    mask = np.ones(len(x1), np.float32)
    rv, _, rok = jg.cheirality_counts(jnp.asarray(Rf), jnp.asarray(tf),
                                      jnp.asarray(x1), jnp.asarray(x2),
                                      jnp.asarray(mask))
    ov, _, ook = tg.cheirality_counts(t(Rf), t(tf), t(x1), t(x2), t(mask))
    assert int(ov) == int(rv)
    np.testing.assert_array_equal(n(ook), np.asarray(rok))


def test_closest_essential_both_forms():
    Es = _essentials()
    for jfn, tfn in ((jg.closest_essential, tg.closest_essential),
                     (jg.closest_essential_fast, tg.closest_essential_fast)):
        ref = np.asarray(jfn(jnp.asarray(Es)))
        out = n(tfn(t(Es)))
        np.testing.assert_allclose(out, ref, atol=1e-5)


def test_smalllinalg_closed_forms():
    rng = np.random.default_rng(4)
    A = rng.normal(size=(16, 3, 3)).astype(np.float32)
    S = (A @ np.swapaxes(A, 1, 2)).astype(np.float32)
    for jr, tr in zip(jl.svd3x3(jnp.asarray(A)), tl.svd3x3(t(A))):
        np.testing.assert_allclose(n(tr), np.asarray(jr), atol=1e-5)
    for jr, tr in zip(jl.eigh_sym3x3(jnp.asarray(S)), tl.eigh_sym3x3(t(S))):
        np.testing.assert_allclose(n(tr), np.asarray(jr), rtol=1e-4,
                                   atol=1e-4)
    M = rng.normal(size=(9, 9)).astype(np.float32)
    P = (M @ M.T + 0.1 * np.eye(9)).astype(np.float32)
    b = rng.normal(size=(9,)).astype(np.float32)
    np.testing.assert_allclose(
        n(tl.chol_solve_unrolled(t(P), t(b))),
        np.asarray(jl.chol_solve_unrolled(jnp.asarray(P), jnp.asarray(b))),
        rtol=1e-4, atol=1e-5)
    v0 = rng.normal(size=(9,)).astype(np.float32)
    for warm in (None, v0):
        ref = np.asarray(jl.min_eigvec_spd(
            jnp.asarray(P), v0=None if warm is None else jnp.asarray(warm)))
        out = n(tl.min_eigvec_spd(t(P), v0=None if warm is None else t(warm)))
        # sign-invariant null-vector comparison
        assert min(np.abs(out - ref).max(), np.abs(out + ref).max()) < 1e-4


@pytest.mark.parametrize("vote_points", [None, 32])
def test_recover_pose(vote_points):
    R, tt, x1, x2 = _scene(5, n_pts=96)
    E = (np.cross(np.eye(3), tt) @ R).astype(np.float32)
    mask = np.ones(len(x1), np.float32)
    rR, rt, rX, rok, rv = jg.recover_pose(
        jnp.asarray(E), jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(mask),
        vote_points=vote_points)
    oR, ot, oX, ook, ov = tg.recover_pose(t(E), t(x1), t(x2), t(mask),
                                          vote_points=vote_points)
    np.testing.assert_allclose(n(oR), np.asarray(rR), atol=1e-4)
    np.testing.assert_allclose(n(ot), np.asarray(rt), atol=1e-4)
    np.testing.assert_array_equal(n(ook), np.asarray(rok))
    assert int(ov) == int(rv) > 80
    assert np.degrees(np.arccos(np.clip(
        (np.trace(R.T @ n(oR).astype(np.float64)) - 1) / 2, -1, 1))) < 0.5


def test_statistics_and_pose_comparison():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(5, 37)).astype(np.float32)
    m = rng.random((5, 37)) > 0.4
    m[0] = False
    np.testing.assert_array_equal(
        n(tg.masked_median(t(x), torch.from_numpy(m))),
        np.asarray(jg.masked_median(jnp.asarray(x), jnp.asarray(m))))
    score = (rng.random(50) > 0.5).astype(np.float32)
    np.testing.assert_array_equal(
        n(tg.spread_select(t(score), 20)),
        np.asarray(jg.spread_select(jnp.asarray(score), 20)))
    R1, t1 = random_pose(rng)
    R2, t2 = random_pose(rng)
    ref = jg.compare_poses(*(jnp.asarray(a, jnp.float32)
                             for a in (R1, t1, R2, t2)))
    out = tg.compare_poses(*(t(a) for a in (R1, t1, R2, t2)))
    for o, r in zip(out, ref):
        np.testing.assert_allclose(float(o), float(r), rtol=1e-5, atol=1e-5)
    a = rng.uniform(-10, 10, 64).astype(np.float32)
    np.testing.assert_array_equal(
        n(tg.floor_mod(t(a), 2 * np.pi)), np.asarray(jnp.mod(a, 2 * np.pi)))


def test_masked_stats_and_distort_oulu_match_jax():
    """masked_stats (AutoTh's residual statistics) and the forward Oulu
    distortion (BA's projection), at rtol 1e-5."""
    rng = np.random.default_rng(4)
    x = np.abs(rng.normal(size=(4, 53))).astype(np.float32)
    m = rng.random((4, 53)) > 0.3
    m[0] = False  # an empty row: zeros on both sides
    for o, r in zip(tg.masked_stats(t(x), torch.from_numpy(m)),
                    jg.masked_stats(jnp.asarray(x), jnp.asarray(m))):
        np.testing.assert_allclose(n(o), np.asarray(r), rtol=1e-5,
                                   atol=1e-7)
    pts = rng.uniform(-0.6, 0.6, (7, 3, 2)).astype(np.float32)
    dist = (rng.normal(size=(3, 5)) * [0.1, 0.02, 0.002, 0.002, 0.005]
            ).astype(np.float32)
    np.testing.assert_allclose(
        n(tg.distort_oulu(t(pts), t(dist))),
        np.asarray(jg.distort_oulu(jnp.asarray(pts), jnp.asarray(dist))),
        rtol=1e-5, atol=1e-7)
    # undistort_oulu inverts it
    back = tg.undistort_oulu(tg.distort_oulu(t(pts[:, 0]), t(dist[0])),
                             t(dist[0]))
    np.testing.assert_allclose(n(back), pts[:, 0], atol=1e-5)
