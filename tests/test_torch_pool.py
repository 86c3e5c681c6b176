"""Correspondence pool (``ops/pool.py``) and the weighted / rotation-only
LM polish: port vs JAX package, slot by slot.

Both packages get the same pool (the JAX package's arrays, loaded with
``convert.pool_from_numpy``) and the same new rows. Masks, indices and
the integer counters (``n_found``, ``age``, ``sampson_count``) must be
bit-exact; f32 fields agree within 1e-6 (1 + |x|), except two computed
from ill-conditioned terms, which get the bound their inputs carry over:
the triangulated point ``q``, whose 3x3 normal equations amplify the
products' last-ulp differences by their condition number (the bound of
``tests/test_torch_geometry.py::test_triangulate_and_cheirality``), and
the weight, whose 0.3 (1 - err / th^2) term scales the Sampson error's
own f32 difference (the epipolar residual is a difference of O(1) terms)
by 0.3 / th^2, and whose far-point penalty 0.5 + 0.45 max_z / z carries
the difference of q's depth.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from matchinglib_poselib_tpu.ops import geometry as jg, pool as jp
from matchinglib_poselib_tpu.ops import refine as jr

from matchinglib_poselib_torch import convert
from matchinglib_poselib_torch.ops import pool as tp
from matchinglib_poselib_torch.ops import refine as trf

from conftest import random_pose
from test_torch_helpers import dir_angle_deg, n, rot_chordal_deg, t

CAP = 1024
K_CAM = np.array([[600.0, 0, 320.0], [0, 600.0, 240.0], [0, 0, 1.0]])
TH_SQ = np.float32((0.8 / 600.0) ** 2)
EXACT = ("valid", "q_valid", "q_too_far", "n_found", "age", "sampson_count",
         # gathered, never computed: equal to the bit
         "pt1", "pt2", "x1", "x2", "desc_dist", "response")


def _rows(rng, R, tt, k, far_frac=0.1, outlier_frac=0.15):
    """k correspondences of the rig (R, t): pixel and camera coords,
    descriptor distances, responses and Sampson errors under E(R, t),
    with a share of far points (z 60-400) and outliers."""
    z = rng.uniform(3.0, 20.0, k)
    far = rng.random(k) < far_frac
    z[far] = rng.uniform(60.0, 400.0, far.sum())
    X = np.stack([rng.uniform(-0.5, 0.5, k) * z,
                  rng.uniform(-0.4, 0.4, k) * z, z], 1)
    x1 = X[:, :2] / X[:, 2:]
    X2 = X @ R.T + tt
    x2 = X2[:, :2] / X2[:, 2:]
    x1 = x1 + rng.normal(scale=3e-4, size=x1.shape)
    x2 = x2 + rng.normal(scale=3e-4, size=x2.shape)
    out = rng.random(k) < outlier_frac
    x2[out] = rng.uniform(-0.5, 0.5, (out.sum(), 2))
    x1, x2 = x1.astype(np.float32), x2.astype(np.float32)
    p1 = (x1 * 600.0 + K_CAM[:2, 2]).astype(np.float32)
    p2 = (x2 * 600.0 + K_CAM[:2, 2]).astype(np.float32)
    E = np.asarray(jg.essential_from_rt(jnp.asarray(R, jnp.float32),
                                        jnp.asarray(tt, jnp.float32)))
    err = np.asarray(jg.sampson_error(jnp.asarray(E), jnp.asarray(x1),
                                      jnp.asarray(x2)))
    dd = rng.uniform(0.0, 120.0, k).astype(np.float32)
    resp = rng.uniform(0.0, 1.0, k).astype(np.float32)
    return dict(p1=p1, p2=p2, x1=x1, x2=x2, dd=dd, resp=resp, err=err)


def _weights(r):
    w = np.asarray(jp.correspondence_weight(
        jnp.asarray(r["err"]), jnp.asarray(r["dd"]), jnp.asarray(r["resp"]),
        jnp.asarray(TH_SQ)))
    return np.array(w)


def _jax_pool(seed, n_rows=700, updates=2):
    """A JAX pool of capacity CAP holding n_rows rows of a rig, after
    `updates` post-acceptance updates (history, q, age, weights)."""
    rng = np.random.default_rng(seed)
    R, tt = random_pose(rng, 8.0)
    r = _rows(rng, R, tt, n_rows)
    w = _weights(r)
    pool = jp.insert_and_evict(
        jp.empty_pool(CAP), *(jnp.asarray(r[k]) for k in (
            "p1", "p2", "x1", "x2", "dd", "resp", "err")),
        jnp.asarray(w), jnp.asarray(r["err"] < 4 * TH_SQ))
    E = jg.essential_from_rt(jnp.asarray(R, jnp.float32),
                             jnp.asarray(tt, jnp.float32))
    for _ in range(updates):
        pool = jp.update_pool_state(pool, E, jnp.asarray(R, jnp.float32),
                                    jnp.asarray(tt, jnp.float32),
                                    jnp.asarray(TH_SQ), jnp.asarray(50.0))
    return pool, rng, R, tt


def _to_port(pool):
    return convert.pool_from_numpy(
        {f: np.array(getattr(pool, f)) for f in jp.Pool._fields})


def _q_bound(R, tt, x1, x2):
    """Per-slot bound on |dq| / |q|: 4 ulp x the normal equations'
    condition number (at least 40)."""
    P2 = np.concatenate([R, tt[:, None]], 1)
    P1 = np.eye(3, 4)
    A = np.stack([x1[:, :1] * P1[2] - P1[0], x1[:, 1:] * P1[2] - P1[1],
                  x2[:, :1] * P2[2] - P2[0], x2[:, 1:] * P2[2] - P2[1]],
                 1)[..., :3]
    cond = np.linalg.cond(np.swapaxes(A, 1, 2) @ A)
    return 4 * 2.0**-24 * np.maximum(cond, 40.0)


def _assert_pool_equal(jpool, tpool, R=None, tt=None, max_z=None):
    for f in jp.Pool._fields:
        a, b = np.asarray(getattr(jpool, f)), n(getattr(tpool, f))
        assert a.shape == b.shape and b.dtype == a.dtype, f
        if f in EXACT:
            assert np.array_equal(a, b), (f, int((a != b).sum()))
        elif f == "q":
            if R is None:  # never triangulated
                assert np.array_equal(a, b), f
                continue
            x1, x2 = np.asarray(jpool.x1), np.asarray(jpool.x2)
            rel = (np.linalg.norm(a - b, axis=1)
                   / np.maximum(np.linalg.norm(a, axis=1), 1e-30))
            bound = _q_bound(np.asarray(R, np.float32).astype(np.float64),
                             np.asarray(tt, np.float32).astype(np.float64),
                             x1.astype(np.float64), x2.astype(np.float64))
            assert np.all(rel <= bound), f
        elif f == "weight":
            d_err = np.abs(n(tpool.sampson) - np.asarray(jpool.sampson))
            zj, zt = np.asarray(jpool.q)[:, 2], n(tpool.q)[:, 2]
            far = np.asarray(jpool.q_too_far) & (zj > 0) & (zt > 0)
            d_pen = (0.0 if max_z is None else np.where(
                far, 0.45 * max_z * np.abs(zt - zj)
                / np.maximum(np.minimum(zj, zt), 1e-9) ** 2, 0.0))
            assert np.all(np.abs(b - a) <= 1e-6 * (1 + np.abs(a))
                          + 0.3 * d_err / TH_SQ + d_pen), f
        else:
            assert np.all(np.abs(b - a) <= 1e-6 * (1 + np.abs(a))), f


def test_empty_pool_and_pool_from_numpy_round_trip():
    jpool = jp.empty_pool(CAP)
    _assert_pool_equal(jpool, tp.empty_pool(CAP))
    pool, _, _, _ = _jax_pool(0)
    back = _to_port(pool)
    for f in jp.Pool._fields:
        assert np.array_equal(np.asarray(getattr(pool, f)),
                              n(getattr(back, f))), f
    assert int(back.n_valid) == int(pool.n_valid)
    np.testing.assert_array_equal(n(back.mean_sampson),
                                  np.asarray(pool.mean_sampson))


@pytest.mark.parametrize("seed", [1, 2])
def test_update_evict_and_stats_match(seed):
    pool, rng, R, tt = _jax_pool(seed, updates=1)
    R2, t2 = R @ _small_rot(rng, 0.02), tt
    E = jg.essential_from_rt(jnp.asarray(R2, jnp.float32),
                             jnp.asarray(t2, jnp.float32))
    tpool = _to_port(pool)
    Et = t(np.asarray(E))
    Rt, ttt = t(R2), t(t2)
    for max_z in (50.0, 130.0):
        ju = jp.update_pool_state(pool, E, jnp.asarray(R2, jnp.float32),
                                  jnp.asarray(t2, jnp.float32),
                                  jnp.asarray(TH_SQ), jnp.asarray(max_z))
        tu = tp.update_pool_state(tpool, Et, Rt, ttt, t(TH_SQ),
                                  torch.tensor(max_z))
        _assert_pool_equal(ju, tu, R2, t2, max_z)
        assert float(tp.far_point_ratio(tu)) == float(jp.far_point_ratio(ju))
    je = jp.evict_outliers(pool, E, jnp.asarray(TH_SQ))
    te = tp.evict_outliers(tpool, Et, t(TH_SQ))
    assert np.array_equal(np.asarray(je.valid), n(te.valid))
    jn, jv, jstats = jp.pool_inlier_stats(pool, E, jnp.asarray(TH_SQ))
    tn, tv, tstats = tp.pool_inlier_stats(tpool, Et, t(TH_SQ))
    assert int(jn) == int(tn) and int(jv) == int(tv)
    for a, b in zip(jstats, tstats):
        assert abs(float(a) - float(b)) <= 1e-6 * (1 + abs(float(a)))


def test_correspondence_weight_with_far_penalty_matches():
    rng = np.random.default_rng(3)
    k = 500
    err = (rng.uniform(0, 3, k) * TH_SQ).astype(np.float32)
    dd = rng.uniform(0, 300, k).astype(np.float32)
    resp = rng.uniform(-0.2, 1.3, k).astype(np.float32)
    far = rng.random(k) < 0.4
    z = rng.uniform(-5.0, 300.0, k).astype(np.float32)
    a = np.asarray(jp.correspondence_weight(
        jnp.asarray(err), jnp.asarray(dd), jnp.asarray(resp),
        jnp.asarray(TH_SQ), q_too_far=jnp.asarray(far), q_z=jnp.asarray(z),
        max_dist_z=jnp.asarray(130.0, jnp.float32)))
    b = n(tp.correspondence_weight(t(err), t(dd), t(resp), t(TH_SQ),
                                   q_too_far=t(far), q_z=t(z),
                                   max_dist_z=torch.tensor(130.0)))
    assert np.all(np.abs(a - b) <= 1e-6 * (1 + np.abs(a)))


def _filter_both(pool, new, w, valid, min_dist=3.0):
    tpool = _to_port(pool)
    a = jp.filter_new_vs_pool(pool, jnp.asarray(new[0]), jnp.asarray(new[1]),
                              jnp.asarray(w), jnp.asarray(valid), min_dist)
    b = tp.filter_new_vs_pool(tpool, t(new[0]), t(new[1]), t(w), t(valid),
                              min_dist)
    for name, x, y in zip(("new_valid", "pool_valid", "n_found"), a, b):
        assert np.array_equal(np.asarray(x), n(y)), (name, int(
            (np.asarray(x) != n(y)).sum()))
    return [np.asarray(x) for x in a]


def test_filter_random_frame_matches():
    """A new frame of rows of the same rig against a filled pool, some
    rows planted on pool points (coincident, same point, nearby)."""
    pool, rng, R, tt = _jax_pool(4)
    r = _rows(rng, R, tt, 300)
    v = np.asarray(pool.valid)
    idx = np.flatnonzero(v)[:60]
    for j, off in enumerate((0.05, 0.8, 2.5)):
        sl = slice(20 * j, 20 * (j + 1))
        r["p1"][sl] = np.asarray(pool.pt1)[idx[sl]] + off * 0.7
        r["p2"][sl] = np.asarray(pool.pt2)[idx[sl]] + off * 0.7
    w = _weights(r)
    w[:60] *= rng.uniform(0.7, 1.5, 60).astype(np.float32)
    nv, pv, nf = _filter_both(pool, (r["p1"], r["p2"]), w,
                              rng.random(300) > 0.1)
    assert (~nv[:60]).any() and (~pv[v]).any() and (nf > 1).any()


def _small_pool(pts, w, age=None, sampson=None, sampson_prev=None):
    pts = np.asarray(pts, np.float32)
    k = len(pts)
    z = jnp.zeros(k, jnp.float32)
    pool = jp.insert_and_evict(
        jp.empty_pool(16), jnp.asarray(pts), jnp.asarray(pts),
        jnp.asarray(pts) / 100, jnp.asarray(pts) / 100, z, z, z,
        jnp.asarray(np.asarray(w, np.float32)), jnp.ones(k, bool))
    if age is not None:
        pool = pool._replace(age=jnp.asarray(np.resize(age, 16), jnp.int32))
    if sampson is not None:
        pool = pool._replace(
            sampson=jnp.asarray(np.resize(sampson, 16), jnp.float32),
            sampson_prev=jnp.asarray(np.resize(sampson_prev, 16),
                                     jnp.float32))
    return pool


@pytest.mark.parametrize("order", ["kill_then_keep", "keep_then_kill",
                                   "kill_then_invalid"])
def test_filter_duplicate_nearest_last_writer_decides(order):
    """Two new rows share their nearest pool point and disagree: one is
    decisively better (kills it), the other worse (keeps it). The JAX
    package's scatter lets the last row decide; so must the port, on
    every device. An invalid row pointing to the slot writes 'keep'."""
    pool = _small_pool([[10.0, 10.0], [50.0, 50.0]], [0.5, 0.9])
    kill = ([10.4, 10.3], 0.9)   # same point, decisively better
    keep = ([10.6, 9.8], 0.3)    # same point, worse
    rows = {"kill_then_keep": (kill, keep), "keep_then_kill": (keep, kill),
            "kill_then_invalid": (kill, keep)}[order]
    pts = np.array([p for p, _ in rows], np.float32)
    w = np.array([x for _, x in rows], np.float32)
    valid = np.array([True, order != "kill_then_invalid"])
    nv, pv, _ = _filter_both(pool, (pts, pts), w, valid)
    slot = int(np.argmax(np.all(np.asarray(pool.pt1) == [10.0, 10.0], 1)
                         & np.asarray(pool.valid)))
    assert pv[slot] == (order == "kill_then_keep" or
                        order == "kill_then_invalid")


def test_filter_coincident_points_bump_n_found_per_row():
    pool = _small_pool([[10.0, 10.0], [30.0, 30.0]], [0.5, 0.6])
    pts = np.array([[10.0, 10.0], [10.02, 10.01], [30.0, 30.0],
                    [30.0, 30.05]], np.float32)
    nv, pv, nf = _filter_both(pool, (pts, pts),
                              np.full(4, 0.9, np.float32), np.ones(4, bool))
    assert not nv.any() and pv.sum() == 2
    assert sorted(nf[np.asarray(pool.valid)].tolist()) == [3, 3]


def test_filter_tie_band_age_and_error_preferences():
    """New rows 5-20% better than the pool point: the old-age (> 15) and
    increasing-error preferences decide."""
    pool = _small_pool([[10.0, 10.0], [30.0, 30.0], [50.0, 50.0]],
                       [0.5, 0.5, 0.5], age=[20, 2, 2],
                       sampson=[1e-7, 2e-7, 1e-7],
                       sampson_prev=[1e-7, 1e-7, 2e-7])
    pts = np.array([[10.5, 10.5], [30.5, 30.5], [50.5, 50.5]], np.float32)
    _filter_both(pool, (pts, pts), np.full(3, 0.56, np.float32),
                 np.ones(3, bool))


def test_filter_and_insert_all_invalid_rows():
    pool, rng, R, tt = _jax_pool(5)
    r = _rows(rng, R, tt, 256)
    w = _weights(r)
    nv, pv, nf = _filter_both(pool, (r["p1"], r["p2"]), w,
                              np.zeros(256, bool))
    assert not nv.any() and np.array_equal(pv, np.asarray(pool.valid))
    _insert_both(pool, r, w, np.zeros(256, bool))


def _insert_both(pool, r, w, valid, R=None, tt=None):
    args = [r[k] for k in ("p1", "p2", "x1", "x2", "dd", "resp", "err")]
    ja = jp.insert_and_evict(pool, *(jnp.asarray(a) for a in args),
                             jnp.asarray(w), jnp.asarray(valid))
    ta = tp.insert_and_evict(_to_port(pool), *(t(a) for a in args), t(w),
                             t(valid))
    _assert_pool_equal(ja, ta)
    return ja


def test_insert_into_full_pool_evicts_lowest():
    pool, rng, R, tt = _jax_pool(6, n_rows=1400)
    assert int(pool.n_valid) == CAP
    r = _rows(rng, R, tt, 300)
    w = _weights(r) + 0.2
    out = _insert_both(pool, r, w, np.ones(300, bool))
    assert int(out.n_valid) == CAP


def test_insert_ties_and_minus_inf_keep_lowest_index():
    """Equal weights and the -inf scores of invalid rows tie: the lowest
    index is kept first, as lax.top_k does."""
    pool, rng, R, tt = _jax_pool(7, n_rows=400)
    pool = pool._replace(weight=jnp.where(pool.valid, 0.5, pool.weight))
    r = _rows(rng, R, tt, 900)
    w = np.full(900, 0.5, np.float32)
    w[::3] = 0.7
    valid = rng.random(900) > 0.1
    out = _insert_both(pool, r, w, valid)
    assert int(out.n_valid) == CAP


def _polish_setup(seed=13):
    rng = np.random.default_rng(seed)
    R, tt = random_pose(rng, 10.0)
    r = _rows(rng, R, tt, 600, far_frac=0.0, outlier_frac=0.2)
    Rn = R @ np.asarray(_small_rot(rng), np.float64)
    inl = (r["err"] < TH_SQ).astype(np.float32)
    return r, Rn.astype(np.float32), tt.astype(np.float32), inl, R, tt


def _small_rot(rng, deg=0.05):
    a = rng.normal(size=3)
    a = a / np.linalg.norm(a) * np.deg2rad(deg)
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    th = np.linalg.norm(a)
    K = K / th
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


@pytest.mark.parametrize("mode", ["point_weights", "rotation_only"])
def test_polish_pose_iterative_weights_and_rotation_only(mode):
    r, R0, t0, inl, R, tt = _polish_setup()
    rng = np.random.default_rng(1)
    valid = np.ones(len(inl), np.float32)
    kw = dict(rounds=3, iterations=6, max_points=256)
    if mode == "point_weights":
        pw = rng.uniform(-0.2, 1.0, len(inl)).astype(np.float32)
        jkw, tkw = dict(point_weights=jnp.asarray(pw)), dict(
            point_weights=t(pw))
    else:
        jkw = tkw = dict(rotation_only=True)
    pj, ij = jr.polish_pose_iterative(
        jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(r["x1"]),
        jnp.asarray(r["x2"]), jnp.asarray(inl), jnp.asarray(valid),
        jnp.asarray(TH_SQ), **kw, **jkw)
    pt, it = trf.polish_pose_iterative(
        t(R0), t(t0), t(r["x1"]), t(r["x2"]), t(inl), t(valid),
        torch.tensor(TH_SQ), **kw, **tkw)
    assert rot_chordal_deg(np.asarray(pj.R), n(pt.R)) < 0.01
    assert dir_angle_deg(np.asarray(pj.t), n(pt.t)) < 0.05
    assert (n(it) == np.asarray(ij)).mean() >= 0.995
    if mode == "rotation_only":
        assert np.array_equal(n(pt.t), t0)
        assert np.array_equal(np.asarray(pj.t), t0)
    assert rot_chordal_deg(R, n(pt.R)) < 0.05
