"""Kneip eigensolver and the KNEIP refinement branch: port vs JAX package.

The same seeded correspondences go through both packages. The port takes
the eigenvalue's gradient and Hessian analytically (simple-eigenvalue
perturbation on ``torch.func`` derivatives of M) and its 3x3 eigen-solves
in closed form; the JAX package differentiates ``jnp.linalg.eigh``.
Tolerances: gradient and Hessian within 1e-3 relative to their largest
entry (f32 derivatives of an eigenvalue near zero). The energy is flat at
its minimum: both sides solve a 3x3 eigenproblem in f32, whose smallest
eigenvalue carries an absolute error of a few ulp of the largest, and a
rotation 0.01-0.09 deg away moves lambda_min by less than that, so the
line search's argmin over its 6 scales can pick another near-tie on
either side. Hence solved poses agree within 0.1 deg (rotation) and
0.25 deg (translation direction); the reported eigenvalues within 1e-5
of trace(M); and the port's rotation is as deep a minimum as the JAX
package's, lambda_min evaluated in float64 no more than 1e-6 of trace(M)
above it. Refinement inlier masks agree on >= 99.5% of slots (the
tolerance of tests/test_torch_robust.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from matchinglib_poselib_tpu import config as jcfg
from matchinglib_poselib_tpu.ops import eigensolver as jeig
from matchinglib_poselib_tpu.ops import geometry as jg
from matchinglib_poselib_tpu.ops import refine as jr

from matchinglib_poselib_torch import config as tcfg
from matchinglib_poselib_torch.ops import eigensolver as teig
from matchinglib_poselib_torch.ops import geometry as tg
from matchinglib_poselib_torch.ops import refine as trf

from conftest import random_pose, synthetic_correspondences
from test_torch_helpers import (
    dir_angle_deg, n, rot_angle_deg, rot_chordal_deg, t,
)


def _scene(seed, n_pts=200, noise=1e-3, outlier_frac=0.0):
    rng = np.random.default_rng(seed)
    R, tt = random_pose(rng, 12.0)
    x1, x2 = synthetic_correspondences(rng, R, tt, n_pts, noise=noise,
                                       outlier_frac=outlier_frac)
    return R, tt, x1.astype(np.float32), x2.astype(np.float32), rng


def _pose_close(Ra, ta, Rb, tb):
    dr = rot_chordal_deg(n(Ra), n(Rb))
    dtt = dir_angle_deg(n(ta), n(tb))
    assert dr < 0.1 and dtt < 0.25, (dr, dtt)


def _energy64(R, x1, x2, w):
    """(lambda_min, trace) of M(R) in float64."""
    def bearings(x):
        b = np.c_[np.asarray(x, np.float64), np.ones(len(x))]
        return b / np.linalg.norm(b, axis=1, keepdims=True)

    nrm = np.cross(bearings(x2), bearings(x1) @ np.asarray(R, np.float64).T)
    M = (nrm * np.asarray(w, np.float64)[:, None]).T @ nrm
    return np.linalg.eigvalsh(M)[0], np.trace(M)


def _as_deep(Rj, Rt, x1, x2, w):
    lam_j, tr = _energy64(n(Rj), x1, x2, w)
    lam_t, _ = _energy64(n(Rt), x1, x2, w)
    assert lam_t <= lam_j + 1e-6 * tr, (lam_t, lam_j, tr)


def test_m_derivatives_match_autodiff():
    """The closed-form first and second derivatives of M in the Cayley
    vector equal torch.func.jacfwd's, in float64."""
    from torch.func import jacfwd

    rng = np.random.default_rng(0)
    b1 = torch.nn.functional.normalize(torch.from_numpy(
        rng.normal(size=(50, 3))), dim=1)
    b2 = torch.nn.functional.normalize(torch.from_numpy(
        rng.normal(size=(50, 3))), dim=1)
    w = torch.from_numpy(rng.random(50))
    Rb = teig._cayley_to_rot(torch.tensor([0.1, -0.2, 0.05],
                                          dtype=torch.float64))

    def m_of(c):
        return teig._m_matrix(Rb @ teig._cayley_to_rot(c[None])[0], b1, b2, w)

    c0 = torch.zeros(3, dtype=torch.float64)
    M, dM, ddM = teig._m_derivatives(Rb, b1, b2, w)
    for got, want in ((M, m_of(c0)), (dM, jacfwd(m_of)(c0)),
                      (ddM, jacfwd(jacfwd(m_of))(c0))):
        np.testing.assert_allclose(n(got), n(want), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gradient_and_hessian_match_jax(seed):
    """At a rotation 2 deg off the truth, the port's analytic derivatives
    of lambda_min equal jax.grad / jax.hessian through eigh."""
    R, _, x1, x2, rng = _scene(seed)
    axis = rng.normal(size=3)
    c = np.tan(np.deg2rad(2.0) / 4) * axis / np.linalg.norm(axis)
    Rbase = (R @ np.asarray(jeig._cayley_to_rot(jnp.asarray(c)))).astype(
        np.float32)
    w = np.ones(len(x1), np.float32)
    b1 = jg.normalize_vec(jg.to_homogeneous(jnp.asarray(x1)))
    b2 = jg.normalize_vec(jg.to_homogeneous(jnp.asarray(x2)))

    def energy(cc):
        return jeig._lambda_min(jeig._m_matrix(
            jnp.asarray(Rbase) @ jeig._cayley_to_rot(cc), b1, b2,
            jnp.asarray(w)))

    z = jnp.zeros(3)
    gj = np.asarray(jax.grad(energy)(z))
    Hj = np.asarray(jax.hessian(energy)(z))
    gt, Ht = teig._grad_hess(
        t(Rbase), tg.normalize_vec(tg.to_homogeneous(t(x1))),
        tg.normalize_vec(tg.to_homogeneous(t(x2))), t(w))
    np.testing.assert_allclose(n(gt), gj, atol=1e-3 * np.abs(gj).max())
    np.testing.assert_allclose(n(Ht), Hj, atol=1e-3 * np.abs(Hj).max())


@pytest.mark.parametrize("seed,seeded", [(0, False), (1, False), (2, True)])
def test_solve_eigensolver_matches_jax(seed, seeded):
    """From the 8pt seed, or from a rotation 3 deg off the truth."""
    R, tt, x1, x2, rng = _scene(seed)
    w = (rng.random(len(x1)) > 0.1).astype(np.float32)
    R0 = None
    if seeded:
        axis = rng.normal(size=3)
        c = np.tan(np.deg2rad(3.0) / 4) * axis / np.linalg.norm(axis)
        R0 = (R @ np.asarray(jeig._cayley_to_rot(jnp.asarray(c)))).astype(
            np.float32)
    rj = jeig.solve_eigensolver(
        jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(w),
        R0=None if R0 is None else jnp.asarray(R0))
    rt = teig.solve_eigensolver(t(x1), t(x2), t(w),
                                R0=None if R0 is None else t(R0))
    _pose_close(rj.R, rj.t, rt.R, rt.t)
    _as_deep(rj.R, rt.R, x1, x2, w)
    _, tr = _energy64(n(rj.R), x1, x2, w)
    assert abs(float(rt.eigenvalue) - float(rj.eigenvalue)) <= 1e-5 * tr
    # and both solve the problem
    assert rot_angle_deg(R, n(rt.R)) < 0.5
    assert dir_angle_deg(tt, n(rt.t)) < 2.0


def test_refine_essential_kneip_matches_jax():
    R, tt, x1, x2, rng = _scene(4, outlier_frac=0.2)
    E0 = jg.essential_from_rt(jnp.asarray(R, jnp.float32),
                              jnp.asarray(tt, jnp.float32))
    err = np.asarray(jg.sampson_error(E0, jnp.asarray(x1), jnp.asarray(x2)))
    inl = err < 1e-5
    rj = jeig.refine_essential_kneip(E0, jnp.asarray(x1), jnp.asarray(x2),
                                     jnp.asarray(inl))
    rt = teig.refine_essential_kneip(t(np.asarray(E0)), t(x1), t(x2),
                                     torch.from_numpy(inl))
    _pose_close(rj.R, rj.t, rt.R, rt.t)
    _as_deep(rj.R, rt.R, x1, x2, inl)


@pytest.mark.parametrize("seed", [0, 1])
def test_refine_essential_linear_kneip_matches_jax(seed):
    """refine_essential_linear with solver=KNEIP: IRLS, then the
    eigensolver polish and its keep rule, on both sides."""
    R, tt, x1, x2, rng = _scene(seed, n_pts=300, outlier_frac=0.25)
    th_sq = np.float32(3e-3) ** 2
    # a perturbed starting model, as the robust stage would hand over
    axis = rng.normal(size=3)
    c = np.tan(np.deg2rad(0.5) / 4) * axis / np.linalg.norm(axis)
    Rp = R @ np.asarray(jeig._cayley_to_rot(jnp.asarray(c)))
    E0 = np.asarray(jg.essential_from_rt(jnp.asarray(Rp, jnp.float32),
                                         jnp.asarray(tt, jnp.float32)))
    mask = np.ones(len(x1), np.float32)
    kw = dict(solver="KNEIP")
    rj = jr.refine_essential_linear(
        jnp.asarray(E0), jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(mask),
        jnp.asarray(th_sq), jcfg.RefinementConfig(
            solver=jcfg.MinimalSolver[kw["solver"]]))
    rt = trf.refine_essential_linear(
        t(E0), t(x1), t(x2), t(mask), torch.tensor(th_sq),
        tcfg.RefinementConfig(solver=tcfg.MinimalSolver[kw["solver"]]))
    agree = (n(rt.inlier_mask) == np.asarray(rj.inlier_mask)).mean()
    assert agree >= 0.995, agree
    mj = jnp.asarray(np.asarray(rj.inlier_mask), jnp.float32)
    Rj, tj, _, _, _ = jg.recover_pose(rj.model, jnp.asarray(x1),
                                      jnp.asarray(x2), mj)
    Rt, ttt, _, _, _ = tg.recover_pose(rt.model, t(x1), t(x2),
                                       rt.inlier_mask.float())
    _pose_close(Rj, tj, Rt, ttt)
    assert rot_angle_deg(R, n(Rt)) < 0.5
