"""Bundle adjustment: port vs JAX package on the same seeded problems.

A small multi-camera rig (80 points, 3 cameras, pixel observations with
0.3 px noise, ~10% of observations missing) starts from perturbed poses,
points and intrinsics; both packages run the same LM, 3 steps. The
reduced camera system has a condition of ~1e10 (focal length against
depth, damped fixed columns), where one f32 step is good to ~1e-3
relative on either side (measured against float64 on this problem: the
JAX package's LU 1e-3, the port's Cholesky 6e-4), and near convergence
the accept test new_cost < cost flips on f32 near-ties: so the steps stay
few. Tolerances: the count of accepted steps equal; costs within 1e-3
relative; rotations within 0.005 deg (chordal); translations within 1e-3
of their scale; points within 5e-3 (depths 6-10); K within 1e-3 of the
focal length; distortion within 5e-3.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from matchinglib_poselib_tpu import config as jcfg
from matchinglib_poselib_tpu.ops import ba as jba

from matchinglib_poselib_torch import config as tcfg
from matchinglib_poselib_torch.ops import ba as tba

from conftest import random_pose
from test_torch_helpers import n, rot_chordal_deg, t

P, C = 80, 3


def _small_rot(rng, deg):
    """Rotation by `deg` degrees about a random axis."""
    a = rng.normal(size=3)
    a /= np.linalg.norm(a)
    Kx = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    th = np.deg2rad(deg)
    return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx


def _problem(seed, dist_scale=0.0):
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-4, 4, P), rng.uniform(-3, 3, P),
                  rng.uniform(6, 10, P)], axis=1)
    R = [np.eye(3)]
    tt = [np.zeros(3)]
    for _ in range(C - 1):
        r, d = random_pose(rng, 6.0)
        R.append(r)
        tt.append(0.3 * d)
    R, tt = np.stack(R), np.stack(tt)
    K = np.tile(np.array([[500.0, 0, 320], [0, 505.0, 240], [0, 0, 1]]),
                (C, 1, 1))
    dist = dist_scale * rng.normal(size=(C, 5)) * np.array(
        [0.1, 0.02, 0.002, 0.002, 0.005])
    obs = np.asarray(jba.jax.vmap(  # pixels through the JAX projection
        jba.jax.vmap(jba._project, in_axes=(None, 0, 0, 0, 0)),
        in_axes=(0, None, None, None, None))(
            jnp.asarray(X, jnp.float32), jnp.asarray(R, jnp.float32),
            jnp.asarray(tt, jnp.float32), jnp.asarray(K, jnp.float32),
            jnp.asarray(dist, jnp.float32)))
    obs = obs + rng.normal(scale=0.3, size=obs.shape)
    vis = rng.random((P, C)) > 0.1
    # perturbed start
    R0 = R.copy()
    for c in range(1, C):
        R0[c] = R[c] @ _small_rot(rng, 0.5)
    t0 = tt + np.concatenate([np.zeros((1, 3)),
                              rng.normal(scale=0.01, size=(C - 1, 3))])
    X0 = X + rng.normal(scale=0.03, size=X.shape)
    K0 = K + np.array([[2.0, 0, 1.0], [0, -2.0, 1.0], [0, 0, 0]])
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return (f32(obs), vis, f32(R0), f32(t0), f32(K0), f32(dist), f32(X0),
            f32(R))


def _check(rj, rt):
    assert int(rt.n_iterations) == int(rj.n_iterations)
    np.testing.assert_allclose(float(rt.final_cost), float(rj.final_cost),
                               rtol=1e-3)
    np.testing.assert_allclose(float(rt.initial_cost),
                               float(rj.initial_cost), rtol=1e-5)
    for c in range(C):
        assert rot_chordal_deg(np.asarray(rj.R)[c], n(rt.R)[c]) < 5e-3
    np.testing.assert_allclose(n(rt.t), np.asarray(rj.t), atol=1e-3 * max(
        1.0, np.abs(np.asarray(rj.t)).max()))
    np.testing.assert_allclose(n(rt.points), np.asarray(rj.points),
                               atol=5e-3)
    np.testing.assert_allclose(n(rt.K), np.asarray(rj.K),
                               atol=1e-3 * float(np.asarray(rj.K)[0, 0, 0]))
    np.testing.assert_allclose(n(rt.dist), np.asarray(rj.dist), atol=5e-3)


# (refine_motion, refine_structure, refine_intrinsics, intrinsics_cols):
# BA_MOTSTRUCT, BA_MOT, BA_STRUCT, BA_MOT_MOTSTRUCT with the optimInternals
# column subsets of refine_multi_cam_ba
MODES = {
    "motstruct": (True, True, False, None),
    "mot": (True, False, False, None),
    "struct": (False, True, False, None),
    "mot_motstruct_all": (True, True, True, None),
    "mot_motstruct_focal": (True, True, True, jba._INTRINSICS_MODES["focal"]),
    "mot_motstruct_dist": (True, True, True, jba._INTRINSICS_MODES["dist"]),
    "mot_motstruct_none": (True, True, True, ()),
}


@pytest.mark.parametrize("intrinsics", [False, True])
def test_analytic_jacobians_match_autodiff(intrinsics):
    """_jacobians is the derivative of _residual: against torch.func.jacfwd
    in float64 (a point behind a camera's clamped depth included)."""
    from torch.func import jacfwd

    obs, vis, R0, t0, K0, dist, X0, _ = _problem(3, dist_scale=1.0)
    f64 = lambda a: torch.from_numpy(np.asarray(a, np.float64))  # noqa
    X = f64(X0[:7])
    X[6] = torch.tensor([0.3, -0.2, 0.0])  # depth 0 in camera 0: clamped
    args = (X, f64(obs[:7]), f64(R0), f64(t0), f64(K0), f64(dist))
    D = tba.DOF_FULL if intrinsics else tba.DOF_POSE
    r, Jc, Jx = tba._jacobians(*args, intrinsics)
    zc = torch.zeros((C, D), dtype=torch.float64)
    zx = torch.zeros((7, 3), dtype=torch.float64)
    Ac, Ax = jacfwd(lambda a, b: tba._residual(a, b, *args, intrinsics),
                    argnums=(0, 1))(zc, zx)
    cams, pts = torch.arange(C), torch.arange(7)
    ref_c = Ac[:, cams, :, cams].permute(1, 0, 2, 3)  # (P, C, 2, D)
    ref_x = Ax[pts, :, :, pts]  # (P, C, 2, 3)
    np.testing.assert_allclose(n(r), n(tba._residual(zc, zx, *args,
                                                     intrinsics)),
                               rtol=1e-12, atol=1e-9)
    np.testing.assert_allclose(n(Jc), n(ref_c), rtol=1e-9,
                               atol=1e-9 * float(ref_c.abs().max()))
    np.testing.assert_allclose(n(Jx), n(ref_x), rtol=1e-9,
                               atol=1e-9 * float(ref_x.abs().max()))


def test_cholesky_solve_matches_float64():
    """The port's camera-system solve on a random SPD system with a spread
    of scales, against float64."""
    rng = np.random.default_rng(0)
    A = rng.normal(size=(12, 12))
    A = A @ A.T + 0.1 * np.eye(12)
    s = np.exp(rng.uniform(-3, 3, 12))
    A = A * s[:, None] * s[None, :]
    b = rng.normal(size=12)
    x = tba._chol_solve(torch.tensor(A, dtype=torch.float32),
                        torch.tensor(b, dtype=torch.float32)).numpy()
    x64 = np.linalg.solve(A, b)
    assert np.abs(x - x64).max() <= 1e-3 * np.abs(x64).max()


@pytest.mark.parametrize("mode", sorted(MODES))
def test_bundle_adjust_modes_match_jax(mode):
    motion, structure, intr, cols = MODES[mode]
    obs, vis, R0, t0, K0, dist, X0, _ = _problem(
        1, dist_scale=1.0 if intr else 0.0)
    free = np.array([0.0] + [1.0] * (C - 1), np.float32)
    kw = dict(iterations=3, robust=True, huber_delta=2.0,
              refine_intrinsics=intr, refine_structure=structure,
              refine_motion=motion, intrinsics_cols=cols)
    rj = jba.bundle_adjust(*(jnp.asarray(a) for a in (
        obs, vis, R0, t0, K0, dist, X0, free)), **kw)
    rt = tba.bundle_adjust(*(torch.from_numpy(np.asarray(a)) for a in (
        obs, vis, R0, t0, K0, dist, X0, free)), **kw)
    assert int(rt.n_iterations) > 0
    assert float(rt.final_cost) < float(rt.initial_cost)
    _check(rj, rt)
    if not structure:
        np.testing.assert_array_equal(n(rt.points), X0)
    if not motion:
        np.testing.assert_array_equal(n(rt.R), R0)


def test_bundle_adjust_least_squares_cost():
    obs, vis, R0, t0, K0, dist, X0, _ = _problem(2)
    free = np.array([0.0] + [1.0] * (C - 1), np.float32)
    kw = dict(iterations=3, robust=False)
    rj = jba.bundle_adjust(*(jnp.asarray(a) for a in (
        obs, vis, R0, t0, K0, dist, X0, free)), **kw)
    rt = tba.bundle_adjust(*(torch.from_numpy(np.asarray(a)) for a in (
        obs, vis, R0, t0, K0, dist, X0, free)), **kw)
    _check(rj, rt)


def _stereo(seed, corrupt=False):
    """Two-view problem in normalized coordinates, as estimate_pose hands
    it to refine_stereo_ba (K = I, triangulated points)."""
    from matchinglib_poselib_torch.ops import geometry as tg

    rng = np.random.default_rng(seed)
    R, d = random_pose(rng, 10.0)
    X = np.stack([rng.uniform(-2, 2, 120), rng.uniform(-2, 2, 120),
                  rng.uniform(4, 12, 120)], axis=1)
    x1 = X[:, :2] / X[:, 2:]
    X2 = X @ R.T + d
    x2 = X2[:, :2] / X2[:, 2:]
    x1 = (x1 + rng.normal(scale=5e-4, size=x1.shape)).astype(np.float32)
    x2 = (x2 + rng.normal(scale=5e-4, size=x2.shape)).astype(np.float32)
    Rs = (R @ _small_rot(rng, 0.5)).astype(np.float32)
    ts = (d + rng.normal(scale=0.01, size=3)).astype(np.float32)
    ts = ts / np.linalg.norm(ts)
    Xs = n(tg.triangulate_linear(t(Rs), t(ts), t(x1), t(x2)))
    if corrupt:
        x2 = x2 + rng.normal(scale=0.05, size=x2.shape).astype(np.float32)
    mask = np.ones(120, np.float32)
    mask[::9] = 0.0
    return Rs, ts, x1, x2, Xs, mask, R, d


@pytest.mark.parametrize("case", ["default", "tight_guard", "corrupt"])
def test_refine_stereo_ba_matches_jax(case):
    Rs, ts, x1, x2, Xs, mask, R, d = _stereo(6, corrupt=case == "corrupt")
    angle = 1e-6 if case == "tight_guard" else 1.25
    eye = np.eye(3, dtype=np.float32)
    hd = np.float32(1.0 / 700.0)
    rj = jba.refine_stereo_ba(
        *(jnp.asarray(a) for a in (Rs, ts, x1, x2, Xs, mask, eye, eye)),
        jcfg.BAConfig(enabled=True, angle_thresh_deg=angle),
        huber_delta=jnp.asarray(hd))
    rt = tba.refine_stereo_ba(
        *(t(a) for a in (Rs, ts, x1, x2, Xs, mask, eye, eye)),
        tcfg.BAConfig(enabled=True, angle_thresh_deg=angle),
        huber_delta=torch.tensor(hd))
    assert bool(rt.restored) == bool(rj.restored)
    if case == "default":
        assert not bool(rt.restored)
        assert rot_chordal_deg(np.asarray(rj.R), n(rt.R)) < 1e-3
        np.testing.assert_allclose(n(rt.t), np.asarray(rj.t), atol=1e-4)
        np.testing.assert_allclose(n(rt.points), np.asarray(rj.points),
                                   atol=1e-3 * np.abs(Xs).max())
        # BA moves the perturbed pose toward the truth
        assert rot_chordal_deg(R, n(rt.R)) < rot_chordal_deg(R, Rs)
        np.testing.assert_allclose(float(rt.final_cost),
                                   float(rj.final_cost), rtol=1e-3)
    else:
        # restored: the input pose comes back exactly
        assert bool(rt.restored)
        np.testing.assert_array_equal(n(rt.R), Rs)
        np.testing.assert_array_equal(n(rt.t), n(t(ts) / torch.clamp(
            torch.linalg.norm(t(ts)), min=1e-12)))
        np.testing.assert_array_equal(n(rt.points), Xs)


@pytest.mark.parametrize("mode,with_dist,motion_only", [
    ("all", True, False), ("focal", False, False), ("dist", True, False),
    ("all", False, True),
])
def test_refine_multi_cam_ba_matches_jax(mode, with_dist, motion_only):
    obs, vis, R0, t0, K0, dist, X0, R_true = _problem(
        4, dist_scale=1.0 if with_dist else 0.0)
    kw = dict(iterations=3, refine_intrinsics=True, intrinsics_mode=mode,
              motion_only=motion_only, huber_delta=2.0)
    rj, resj = jba.refine_multi_cam_ba(
        *(jnp.asarray(a) for a in (obs, vis, R0, t0, K0, X0)),
        dist=jnp.asarray(dist) if with_dist else None, **kw)
    rt, rest = tba.refine_multi_cam_ba(
        *(torch.from_numpy(a) for a in (obs, vis, R0, t0, K0, X0)),
        dist=torch.from_numpy(dist) if with_dist else None, **kw)
    np.testing.assert_array_equal(n(rest), np.asarray(resj))
    assert not bool(n(rest)[0])
    _check(rj, rt)
    if motion_only:
        np.testing.assert_array_equal(n(rt.points), X0)
