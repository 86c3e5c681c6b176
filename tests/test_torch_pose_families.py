"""Port parity: the library-only estimators and geometry, against the JAX
package on the CPU.

Covers ``solvers.solve_small`` / ``det_small`` / ``solve_7pt``, the
geometry helpers (symmetric epipolar error, residual stats, the
essential check, quaternions), the F / rotation-only families and the
four estimators (fundamental 7pt and 8pt, rotation-only, no-motion,
QDEGSAC) on the cases of tests/test_pose_families.py, fed the JAX
package's samples (``jax_uniforms``), and the small functions no JAX
caller reaches (``gather_matched_points``, ``sof_spatial_penalty``,
``match_descriptors(spatial_penalty=...)``, ``brief_descriptor``).

Tolerances: the small solves to 1e-5 relative and ``det_small`` bit for
bit on matrices of small integers, whose columns tie often (the same
first-maximum pivots, the same elementwise ops); ``solve_7pt`` in
float64 (the JAX package under ``jax.enable_x64``): every valid JAX model
matched by a port model within 1e-4 (unit norm, up to sign, Frobenius)
and the same root count on >= 98% of the samples, and in float32 the
port's models no farther from the float64 ones than 1.5x the JAX
package's (median and 90th percentile) — in float32 each package's
models lie ~1e-4 from the float64 solution (the nullspace of A^T A
squares the conditioning), and a sample whose cubic has disc ~ 0 can
switch between one and three roots; geometry to 1e-6 relative (quaternions up
to sign); estimators: inlier masks on >= 99% of slots, ``n_inliers``
within 1%, counters equal, no-motion exact, QDEGSAC's decision equal;
the matching helpers bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from matchinglib_poselib_tpu.config import RobustConfig as JRobust
from matchinglib_poselib_tpu.ops import features as jfeat
from matchinglib_poselib_tpu.ops import filters as jfilt
from matchinglib_poselib_tpu.ops import geometry as jgeo
from matchinglib_poselib_tpu.ops import matching as jmatch
from matchinglib_poselib_tpu.ops import robust as jrob
from matchinglib_poselib_tpu.ops import solvers as jsol
from matchinglib_poselib_torch.config import RobustConfig as TRobust
from matchinglib_poselib_torch.ops import features as tfeat
from matchinglib_poselib_torch.ops import filters as tfilt
from matchinglib_poselib_torch.ops import geometry as tgeo
from matchinglib_poselib_torch.ops import matching as tmatch
from matchinglib_poselib_torch.ops import robust as trob
from matchinglib_poselib_torch.ops import solvers as tsol

from conftest import random_pose, synthetic_correspondences
from test_torch_helpers import jax_uniforms, n, t, words_u32_to_i32

MASK_AGREE = 0.99
INLIER_RTOL = 0.01
SEVEN_PT_MATCH = 0.98
TH_SQ = (2e-3) ** 2
COUNTERS = ("n_batches", "n_hypotheses", "n_models_generated",
            "n_models_rejected", "n_points_verified")


def _pad(x, N):
    out = np.zeros((N, x.shape[1]), np.float32)
    out[: x.shape[0]] = x
    return out


def _rel_close(a, b, rtol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(np.abs(b).max(), 1e-30)
    return np.abs(a - b).max() / scale <= rtol, np.abs(a - b).max() / scale


def _unit_F(F):
    F = np.asarray(F, np.float64)
    F = F / np.linalg.norm(F)
    i = np.argmax(np.abs(F))
    return F * np.sign(F.flat[i])


# ---------------------------------------------------------------------------
# small solves
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_dim", [3, 5, 10])
def test_solve_small_and_det_small(n_dim):
    rng = np.random.default_rng(n_dim)
    # general matrices, and small integers whose columns tie often
    for A in (rng.normal(size=(64, n_dim, n_dim)),
              rng.integers(-3, 4, size=(64, n_dim, n_dim)).astype(float)
              + 8.0 * np.eye(n_dim) * (rng.random((64, 1, 1)) < 0.5)):
        A = A.astype(np.float32)
        B = rng.normal(size=(64, n_dim, 2)).astype(np.float32)
        xj = np.asarray(jsol.solve_small(jnp.asarray(A), jnp.asarray(B)))
        xt = n(tsol.solve_small(t(A), t(B)))
        ok = np.all(np.isfinite(xj), axis=(1, 2))
        assert ok.mean() > 0.9
        assert np.array_equal(np.isfinite(xj), np.isfinite(xt))
        good, err = _rel_close(xt[ok], xj[ok], 1e-5)
        assert good, err
        dj = np.asarray(jsol.det_small(jnp.asarray(A)))
        dt = n(tsol.det_small(t(A)))
        np.testing.assert_array_equal(dt, dj)


def _seven_pt_samples(seed=7, batch=200):
    rng = np.random.default_rng(seed)
    x1s, x2s = [], []
    for _ in range(batch):
        R, tt = random_pose(rng)
        a, b = synthetic_correspondences(rng, R, tt, 7, noise=1e-3)
        x1s.append(a)
        x2s.append(b)
    return np.asarray(x1s), np.asarray(x2s)


def _f_dist(F, G):
    """Frobenius distance of unit-norm models, up to sign."""
    F = F / np.linalg.norm(F)
    G = G / np.linalg.norm(G)
    return min(np.linalg.norm(F - G), np.linalg.norm(F + G))


def _worst_cover(F, v, G, w):
    """Per sample: the largest distance from a valid model of (F, v) to
    the nearest valid model of (G, w) (inf where (G, w) has none)."""
    return np.asarray([
        max((min((_f_dist(F[s, m], G[s, r]) for r in range(3) if w[s, r]),
                 default=np.inf) for m in range(3) if v[s, m]), default=0.0)
        for s in range(F.shape[0])])


def test_solve_7pt_models_match():
    """In float64 the two packages' models agree to 1e-4 (the same
    nullspace, cubic and root branches); in float32 both lie ~1e-4 (median)
    from the float64 solution of the same inputs, so the port is held to
    the JAX package's own distance from it."""
    x1, x2 = _seven_pt_samples()
    with jax.enable_x64(True):
        Fj64, vj64 = (np.asarray(a) for a in jsol.solve_7pt(
            jnp.asarray(x1), jnp.asarray(x2)))
    assert Fj64.dtype == np.float64
    Ft64, vt64 = (n(a) for a in tsol.solve_7pt(torch.from_numpy(x1),
                                               torch.from_numpy(x2)))
    assert vj64[:, 0].all()
    assert (_worst_cover(Fj64, vj64, Ft64, vt64) < 1e-4).mean() \
        >= SEVEN_PT_MATCH
    assert (vj64.sum(1) == vt64.sum(1)).mean() >= SEVEN_PT_MATCH
    # float32: each package's distance from the float64 models
    x1f, x2f = x1.astype(np.float32), x2.astype(np.float32)
    Fj, vj = (np.asarray(a) for a in jsol.solve_7pt(jnp.asarray(x1f),
                                                     jnp.asarray(x2f)))
    Ft, vt = (n(a) for a in tsol.solve_7pt(t(x1f), t(x2f)))
    d_jax = _worst_cover(Fj, vj, Ft64, vt64)
    d_port = _worst_cover(Ft, vt, Ft64, vt64)
    for q in (50, 90):
        assert np.percentile(d_port, q) <= 1.5 * np.percentile(d_jax, q), q
    # every valid port model solves its seven points
    h1 = np.concatenate([x1f, np.ones_like(x1f[..., :1])], -1)
    h2 = np.concatenate([x2f, np.ones_like(x2f[..., :1])], -1)
    res = np.abs(np.einsum("bni,brij,bnj->brn", h2, Ft, h1))
    assert np.all(res[vt] < 1e-4)


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------


def test_geometry_helpers():
    rng = np.random.default_rng(3)
    R, tt = random_pose(rng)
    x1, x2 = synthetic_correspondences(rng, R, tt, 200, noise=1e-3,
                                       outlier_frac=0.2)
    x1, x2 = x1.astype(np.float32), x2.astype(np.float32)
    E = np.asarray(jgeo.essential_from_rt(jnp.asarray(R, jnp.float32),
                                          jnp.asarray(tt, jnp.float32)))
    Es = np.stack([E, E + 0.05 * rng.normal(size=(3, 3))]).astype(
        np.float32)
    mask = rng.random(200) < 0.8
    for Ei in Es:
        good, err = _rel_close(
            n(tgeo.symmetric_epipolar_error(t(Ei), t(x1), t(x2))),
            jgeo.symmetric_epipolar_error(jnp.asarray(Ei), jnp.asarray(x1),
                                          jnp.asarray(x2)), 1e-6)
        assert good, err
        for m in (None, mask):
            sj = jgeo.essential_residual_stats(
                jnp.asarray(Ei), jnp.asarray(x1), jnp.asarray(x2),
                None if m is None else jnp.asarray(m))
            st = tgeo.essential_residual_stats(
                t(Ei), t(x1), t(x2), None if m is None else torch.tensor(m))
            for a, b in zip(st, sj):
                good, err = _rel_close(n(a), b, 1e-6)
                assert good, err
    assert np.array_equal(n(tgeo.is_valid_essential(t(Es))),
                          np.asarray(jgeo.is_valid_essential(
                              jnp.asarray(Es))))
    assert n(tgeo.is_valid_essential(t(Es))).tolist() == [True, False]
    # rotations hitting each of Shepperd's four pivots
    Rs = [random_pose(rng, 170.0)[0] for _ in range(64)]
    Rs += [np.diag(d) for d in ([1, 1, 1], [1, -1, -1], [-1, 1, -1],
                                [-1, -1, 1])]
    Rs = np.asarray(Rs, np.float32)
    qj = np.asarray(jgeo.quat_from_rot(jnp.asarray(Rs)))
    qt = n(tgeo.quat_from_rot(t(Rs)))
    sign = np.where(np.sum(qj * qt, axis=-1, keepdims=True) < 0, -1.0, 1.0)
    good, err = _rel_close(qt * sign, qj, 1e-6)
    assert good, err
    a = rng.normal(size=(32, 4)).astype(np.float32)
    b = rng.normal(size=(32, 4)).astype(np.float32)
    good, err = _rel_close(n(tgeo.quat_mult(t(a), t(b))),
                           jgeo.quat_mult(jnp.asarray(a), jnp.asarray(b)),
                           1e-6)
    assert good, err


# ---------------------------------------------------------------------------
# families
# ---------------------------------------------------------------------------


def test_families_solve_and_error():
    rng = np.random.default_rng(5)
    R, tt = random_pose(rng, 10.0)
    x1, x2 = synthetic_correspondences(rng, R, tt, 64, noise=5e-4)
    x1, x2 = x1.astype(np.float32), x2.astype(np.float32)
    s1, s2 = x1[:56].reshape(8, 7, 2), x2[:56].reshape(8, 7, 2)
    for jf, tf, k in ((jrob.fundamental_8pt_family(),
                       trob.fundamental_8pt_family(), 8),
                      (jrob.rotation_only_family(),
                       trob.rotation_only_family(), 2)):
        assert (tf.name, tf.sample_size, tf.models_per_sample) == (
            jf.name, jf.sample_size, jf.models_per_sample)
        # minimal samples: compared in float64, where the solves are
        # conditioned well enough to agree to 1e-6
        a, b = x1[:8 * k].reshape(8, k, 2), x2[:8 * k].reshape(8, k, 2)
        with jax.enable_x64(True):
            Mj, vj = (np.asarray(m) for m in jf.solve(
                jnp.asarray(a, jnp.float64), jnp.asarray(b, jnp.float64)))
        Mt, vt = (n(m) for m in tf.solve(
            torch.from_numpy(a.astype(np.float64)),
            torch.from_numpy(b.astype(np.float64))))
        assert Mj.dtype == np.float64 and vj.all()
        assert np.array_equal(vt, vj)
        Mj = np.stack([_unit_F(m) for m in Mj[:, 0]])
        Mt = np.stack([_unit_F(m) for m in Mt[:, 0]])
        assert np.abs(Mt - Mj).max() < 1e-6
        Mf = Mj.astype(np.float32)
        ej = jf.error(jnp.asarray(Mf), jnp.asarray(x1), jnp.asarray(x2))
        et = tf.error(t(Mf), t(x1), t(x2))
        good, err = _rel_close(n(et), ej, 1e-5)
        assert good, err
    jf, tf = jrob.fundamental_7pt_family(), trob.fundamental_7pt_family()
    assert (tf.name, tf.sample_size, tf.models_per_sample) == (
        jf.name, jf.sample_size, jf.models_per_sample)
    Ft, vt = tf.solve(t(s1), t(s2))
    assert Ft.shape == (8, 3, 3, 3) and vt.shape == (8, 3)


# ---------------------------------------------------------------------------
# estimators on the cases of tests/test_pose_families.py
# ---------------------------------------------------------------------------


def _fundamental_case():
    rng = np.random.default_rng(42)
    R, tt = random_pose(rng)
    x1, x2 = synthetic_correspondences(rng, R, tt, 300, noise=5e-4,
                                       outlier_frac=0.4)
    return _pad(x1, 512), _pad(x2, 512), np.arange(512) < 300


def _rotation_case():
    rng = np.random.default_rng(42)
    R, _ = random_pose(rng, max_angle_deg=10.0)
    n_pts = 200
    X = np.stack([rng.uniform(-2, 2, n_pts), rng.uniform(-2, 2, n_pts),
                  rng.uniform(4, 12, n_pts)], axis=1)
    x1 = X[:, :2] / X[:, 2:3]
    X2 = X @ R.T
    x2 = X2[:, :2] / X2[:, 2:3]
    x2 += rng.normal(scale=2e-4, size=x2.shape)
    x2[:60] = rng.uniform(-0.5, 0.5, (60, 2))
    return _pad(x1, 256), _pad(x2, 256), np.arange(256) < n_pts, R


def _qdegsac_case(pure_rotation):
    rng = np.random.default_rng(42)
    R, tt = random_pose(rng, max_angle_deg=10.0)
    n_pts = 300
    if pure_rotation:
        X = np.stack([rng.uniform(-2, 2, n_pts), rng.uniform(-2, 2, n_pts),
                      rng.uniform(4, 12, n_pts)], axis=1)
        x1 = X[:, :2] / X[:, 2:3]
        X2 = X @ R.T
        x2 = X2[:, :2] / X2[:, 2:3]
        x2 = x2 + rng.normal(scale=2e-4, size=x2.shape)
    else:
        x1, x2 = synthetic_correspondences(rng, R, tt, n_pts, noise=2e-4)
    return _pad(x1, 512), _pad(x2, 512), np.arange(512) < n_pts


def _check_result(rt, rj, model=True, counters=COUNTERS):
    mt, mj = n(rt.inlier_mask), np.asarray(rj.inlier_mask)
    assert (mt == mj).mean() >= MASK_AGREE, (mt != mj).sum()
    nj = int(rj.n_inliers)
    assert abs(int(rt.n_inliers) - nj) <= INLIER_RTOL * nj
    for c in counters:
        assert int(getattr(rt, c)) == int(getattr(rj, c)), c
    if model:
        assert np.abs(_unit_F(n(rt.model)) - _unit_F(rj.model)).max() < 1e-3


@pytest.mark.parametrize("use_8pt", [False, True])
def test_estimate_fundamental_robust(use_8pt):
    x1, x2, mask = _fundamental_case()
    kw = dict(batch_hypotheses=256, max_batches=4, prosac=False,
              check_degeneracy=False, lo_refine=False)
    key = jax.random.PRNGKey(0)
    rj = jrob.estimate_fundamental_robust(
        jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(mask), None,
        JRobust(**kw), key, threshold_sq=TH_SQ, use_8pt=use_8pt)
    rt = trob.estimate_fundamental_robust(
        t(x1), t(x2), torch.tensor(mask), None, TRobust(**kw),
        threshold_sq=TH_SQ, use_8pt=use_8pt,
        uniforms=jax_uniforms(key, 4, 256, 8 if use_8pt else 7))
    assert int(rj.n_inliers) > 120
    _check_result(rt, rj)


def test_estimate_rotation_robust():
    x1, x2, mask, R = _rotation_case()
    kw = dict(batch_hypotheses=128, max_batches=3, prosac=False,
              check_degeneracy=False, lo_refine=False)
    key = jax.random.PRNGKey(1)
    rj = jrob.estimate_rotation_robust(
        jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(mask), None,
        JRobust(**kw), key, threshold_sq=TH_SQ)
    rt = trob.estimate_rotation_robust(
        t(x1), t(x2), torch.tensor(mask), None, TRobust(**kw),
        threshold_sq=TH_SQ, uniforms=jax_uniforms(key, 3, 128, 2))
    _check_result(rt, rj, model=False)
    assert np.abs(n(rt.model) - np.asarray(rj.model)).max() < 1e-4
    ang = np.degrees(np.arccos(np.clip(
        (np.trace(n(rt.model).T @ R) - 1) / 2, -1, 1)))
    assert int(rt.n_inliers) > 100 and ang < 0.2, ang


def test_estimate_rotation_robust_refit_needs_strict_gain():
    """An empty mask: the all-points refit is rank deficient and must not
    displace the RANSAC model on the 0-0 tie, in either package."""
    x1, x2, _, _ = _rotation_case()
    mask = np.zeros(len(x1), bool)
    kw = dict(batch_hypotheses=16, max_batches=1, prosac=False,
              check_degeneracy=False, lo_refine=False)
    key = jax.random.PRNGKey(4)
    rj = jrob.estimate_rotation_robust(
        jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(mask), None,
        JRobust(**kw), key, threshold_sq=TH_SQ)
    rt = trob.estimate_rotation_robust(
        t(x1), t(x2), torch.tensor(mask), None, TRobust(**kw),
        threshold_sq=TH_SQ, uniforms=jax_uniforms(key, 1, 16, 2))
    assert int(rt.n_inliers) == int(rj.n_inliers) == 0
    assert np.allclose(n(rt.model), np.asarray(rj.model), atol=1e-5)


def test_estimate_nomotion_robust_exact():
    rng = np.random.default_rng(42)
    n_pts = 400
    x1 = rng.uniform(-0.5, 0.5, (n_pts, 2)).astype(np.float32)
    x2 = x1 + rng.normal(scale=2e-4, size=(n_pts, 2)).astype(np.float32)
    out_idx = rng.choice(n_pts, 40, replace=False)
    x2[out_idx] += rng.uniform(0.05, 0.3, (40, 2)).astype(np.float32)
    R, tt = random_pose(rng, max_angle_deg=10.0)
    x1m, x2m = synthetic_correspondences(rng, R, tt, n_pts, noise=1e-4)
    for a, b in ((x1, x2), (x1m.astype(np.float32), x2m.astype(np.float32))):
        mask = np.ones(n_pts, np.float32)
        mask[::7] = 0.0
        rj = jrob.estimate_nomotion_robust(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(mask), None,
            JRobust(), threshold_sq=jnp.asarray(1e-6, jnp.float32))
        rt = trob.estimate_nomotion_robust(t(a), t(b), t(mask), None,
                                           TRobust(), threshold_sq=1e-6)
        for f in rj._fields:
            np.testing.assert_array_equal(n(getattr(rt, f)),
                                          np.asarray(getattr(rj, f)), f)


@pytest.mark.parametrize("pure_rotation", [True, False])
def test_qdegsac_decision(pure_rotation):
    x1, x2, mask = _qdegsac_case(pure_rotation)
    N = len(x1)
    q = np.ones(N, np.float32)
    kw = dict(batch_hypotheses=256, max_batches=4, prosac=False,
              check_degeneracy=False)
    key = jax.random.PRNGKey(2)
    jcfg, tcfg = JRobust(**kw), TRobust(**kw)
    out_j = jrob.estimate_essential_qdegsac(
        jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(mask), jnp.asarray(q),
        jcfg, key, threshold_sq=TH_SQ)
    kf, kr, ke = jax.random.split(key, 3)
    shapes = trob.qdegsac_sample_shapes(tcfg)
    streams = tuple(jax_uniforms(k, *s) for k, s in zip((kf, kr, ke),
                                                         shapes))
    out_t = trob.estimate_essential_qdegsac(
        t(x1), t(x2), torch.tensor(mask), t(q), tcfg, threshold_sq=TH_SQ,
        uniforms=streams)
    assert bool(out_t.is_degenerate) == bool(out_j.is_degenerate) \
        == pure_rotation, (float(out_t.rot_fraction),
                           float(out_j.rot_fraction))
    # which solves of a sample come out invalid is rounding's choice where
    # the samples are degenerate (every F = [e]x R fits a pure rotation)
    # and for Nister's weakly crossing roots (tests/test_torch_solvers.py)
    free = tuple(c for c in COUNTERS if c not in (
        "n_models_rejected", "n_points_verified"))
    if pure_rotation:
        # and so are the F and E models themselves
        _check_result(out_t.F_result, out_j.F_result, False, free)
        _check_result(out_t.result, out_j.result, False, free)
    else:
        _check_result(out_t.F_result, out_j.F_result)
        _check_result(out_t.result, out_j.result, True, free)
    _check_result(out_t.R_result, out_j.R_result, model=False)
    assert abs(float(out_t.rot_fraction) - float(out_j.rot_fraction)) < 0.02


# ---------------------------------------------------------------------------
# small functions with no JAX caller
# ---------------------------------------------------------------------------


def _descriptor_case(rng, n1=96, n2=112):
    d1 = rng.integers(0, 2**32, (n1, 8), dtype=np.uint32)
    d2 = rng.integers(0, 2**32, (n2, 8), dtype=np.uint32)
    # near copies, so that some matches pass the ratio test
    d2[:n1 // 2] = d1[:n1 // 2] ^ (rng.integers(0, 2**32, (n1 // 2, 8),
                                               dtype=np.uint32)
                                   & rng.integers(0, 2**32, (n1 // 2, 8),
                                                  dtype=np.uint32)
                                   & rng.integers(0, 2**32, (n1 // 2, 8),
                                                  dtype=np.uint32))
    p1 = rng.uniform(0, 200, (n1, 2)).astype(np.float32)
    p2 = np.concatenate([p1[:n1 // 2] + rng.normal(0, 2, (n1 // 2, 2)),
                         rng.uniform(0, 200, (n2 - n1 // 2, 2))]).astype(
        np.float32)
    return d1, d2, p1, p2


def _sof_field(rng, gy=5, gx=6):
    flow = rng.normal(0, 3, (gy, gx, 2)).astype(np.float32)
    rad = rng.uniform(4, 20, (gy, gx)).astype(np.float32)
    valid = rng.random((gy, gx)) < 0.8
    return (jfilt.SOFField(jnp.asarray(flow), jnp.asarray(rad),
                           jnp.asarray(valid)),
            tfilt.SOFField(t(flow), t(rad), torch.tensor(valid)))


def test_sof_spatial_penalty_and_penalised_matching_exact():
    rng = np.random.default_rng(11)
    d1, d2, p1, p2 = _descriptor_case(rng)
    fj, ft = _sof_field(rng)
    pen_j = jfilt.sof_spatial_penalty(fj, jnp.asarray(p1), jnp.asarray(p2),
                                      40)
    pen_t = tfilt.sof_spatial_penalty(ft, t(p1), t(p2), 40)
    np.testing.assert_array_equal(n(pen_t), np.asarray(pen_j))
    assert 0 < (np.asarray(pen_j) == 0).mean() < 1
    v1 = rng.random(len(d1)) < 0.9
    v2 = rng.random(len(d2)) < 0.9
    fd1 = rng.integers(-8, 9, (len(d1), 16)).astype(np.float32)
    fd2 = np.concatenate([fd1[:48] + rng.integers(-1, 2, (48, 16)),
                          rng.integers(-8, 9, (len(d2) - 48, 16))]).astype(
        np.float32)
    pred = (p1 + rng.normal(0, 2, p1.shape)).astype(np.float32)
    rad = rng.uniform(3, 30, len(p1)).astype(np.float32)
    for binary, (a, b) in ((True, (d1, d2)), (False, (fd1, fd2))):
        ja, jb = jnp.asarray(a), jnp.asarray(b)
        ta, tb = ((words_u32_to_i32(a), words_u32_to_i32(b)) if binary
                  else (t(a), t(b)))
        for kw in (dict(), dict(cross_check=False, ratio_test=False,
                                max_distance=60.0)):
            for guided in (False, True):
                gj = (dict(guide_pred=jnp.asarray(pred),
                           guide_rad=jnp.asarray(rad),
                           pts2_xy=jnp.asarray(p2)) if guided else {})
                gt = (dict(guide_pred=t(pred), guide_rad=t(rad),
                           pts2_xy=t(p2)) if guided else {})
                rj = jmatch.match_descriptors(
                    ja, jb, jnp.asarray(v1), jnp.asarray(v2), binary=binary,
                    spatial_penalty=pen_j, **kw, **gj)
                rt = tmatch.match_descriptors(
                    ta, tb, torch.tensor(v1), torch.tensor(v2),
                    binary=binary, spatial_penalty=pen_t, **kw, **gt)
                for f in rj._fields:
                    np.testing.assert_array_equal(
                        n(getattr(rt, f)), np.asarray(getattr(rj, f)), f)
                assert rt.mask.sum() > 0
                k1, k2, m = tmatch.gather_matched_points(t(p1), t(p2), rt)
                j1, j2, jm = jmatch.gather_matched_points(
                    jnp.asarray(p1), jnp.asarray(p2), rj)
                for a_, b_ in ((k1, j1), (k2, j2), (m, jm)):
                    np.testing.assert_array_equal(n(a_), np.asarray(b_))


@pytest.mark.parametrize("oriented", [True, False])
def test_brief_descriptor_exact(oriented):
    rng = np.random.default_rng(13)
    patches = rng.random((40, 31, 31)).astype(np.float32)
    angles = rng.uniform(-np.pi, np.pi, 40).astype(np.float32)
    dj = jfeat.brief_descriptor(jnp.asarray(patches), jnp.asarray(angles),
                                oriented)
    dt = tfeat.brief_descriptor(t(patches), t(angles), oriented)
    np.testing.assert_array_equal(n(dt), n(words_u32_to_i32(dj)))
