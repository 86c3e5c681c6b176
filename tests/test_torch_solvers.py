"""Minimal and nonminimal solvers: port vs JAX package.

Models are compared up to sign and order: for every valid JAX model there
must be a valid port model within 1e-4 in Frobenius norm after
normalization. The five-point solver is the exception: its Gauss-Jordan
elimination amplifies last-ulp f32 differences to ~1e-4 relative in the
degree-10 polynomial, which decides whether a weakly crossing root is
found at all. Both packages then find every solution that matters — the
true model — and >= 90% of the JAX models (measured: ~95%), and every
valid model of the port solves its five points. Null vectors and
eigenvectors are compared sign-invariantly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from matchinglib_poselib_tpu.ops import solvers as js

from matchinglib_poselib_torch.ops import solvers as ts

from conftest import random_pose, synthetic_correspondences
from test_torch_helpers import n, t


def _samples(seed, batch, k, noise=0.0):
    rng = np.random.default_rng(seed)
    x1s, x2s, poses = [], [], []
    for _ in range(batch):
        R, tt = random_pose(rng, 20.0)
        x1, x2 = synthetic_correspondences(rng, R, tt, k, noise=noise)
        x1s.append(x1)
        x2s.append(x2)
        poses.append((R, tt))
    return (np.stack(x1s).astype(np.float32),
            np.stack(x2s).astype(np.float32), poses)


def _unit(M):
    M = np.asarray(M, np.float64)
    return M / np.linalg.norm(M.reshape(M.shape[:-2] + (-1,)),
                              axis=-1)[..., None, None]


def _sign_free_dist(cand, E):
    return np.minimum(
        np.linalg.norm((cand - E).reshape(len(cand), -1), axis=1),
        np.linalg.norm((cand + E).reshape(len(cand), -1), axis=1),
    )


def _covered(ref, ref_valid, out, out_valid, tol=1e-4):
    """Per valid reference model: is a valid output model within tol?"""
    ref, out = _unit(ref), _unit(out)
    hits = []
    for b in range(ref.shape[0]):
        cand = out[b][out_valid[b]]
        for E in ref[b][ref_valid[b]]:
            hits.append(bool(len(cand))
                        and _sign_free_dist(cand, E).min() < tol)
    return np.asarray(hits)


def _assert_models_covered(ref, ref_valid, out, out_valid, tol=1e-4):
    assert np.all(_covered(ref, ref_valid, out, out_valid, tol))


def test_solve_5pt_nister_models_match():
    x1, x2, poses = _samples(0, 48, 5)
    rE, rv = js.solve_5pt_nister(jnp.asarray(x1), jnp.asarray(x2))
    oE, ov = ts.solve_5pt_nister(t(x1), t(x2))
    rv, ov, oE = np.asarray(rv), n(ov), n(oE)
    assert rv.sum() >= 48
    assert _covered(np.asarray(rE), rv, oE, ov).mean() >= 0.9
    # every valid port model solves its five points
    h1 = np.concatenate([x1, np.ones_like(x1[..., :1])], -1)
    h2 = np.concatenate([x2, np.ones_like(x2[..., :1])], -1)
    res = np.abs(np.einsum("bni,brij,bnj->brn", h2, _unit(oE), h1))
    assert np.all(res[ov] < 1e-5)
    # and the true essential matrix is among the valid models as often as
    # in the JAX package (a true model that is a near-double root can go
    # either way in either package)
    def true_found(E, v):
        return sum(
            bool(v[b].any()) and _sign_free_dist(
                _unit(E[b][v[b]]), _unit(np.cross(np.eye(3), tt) @ R)
            ).min() < 1e-3
            for b, (R, tt) in enumerate(poses)
        )

    n_jax, n_port = true_found(np.asarray(rE), rv), true_found(oE, ov)
    assert n_port >= max(0.9 * len(poses), n_jax - 2), (n_port, n_jax)


@pytest.mark.parametrize("weighted", [False, True])
def test_solve_8pt_models_match(weighted):
    x1, x2, _ = _samples(1, 8, 64, noise=1e-4)
    rng = np.random.default_rng(2)
    mask = (rng.random((8, 64)) > 0.1).astype(np.float32)
    w = rng.uniform(0.2, 1.0, (8, 64)).astype(np.float32) if weighted else None
    rE, rv = js.solve_8pt(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(mask),
                          None if w is None else jnp.asarray(w))
    oE, ov = ts.solve_8pt(t(x1), t(x2), t(mask), None if w is None else t(w))
    np.testing.assert_array_equal(n(ov), np.asarray(rv))
    _assert_models_covered(np.asarray(rE)[:, None], np.asarray(rv)[:, None],
                           n(oE)[:, None], n(ov)[:, None])


@pytest.mark.parametrize("k", [4, 12])
def test_solve_homography_models_match(k):
    rng = np.random.default_rng(3)
    H = np.eye(3) + rng.normal(scale=0.1, size=(3, 3))
    x1 = rng.uniform(-0.5, 0.5, (16, k, 2))
    p = np.concatenate([x1, np.ones_like(x1[..., :1])], -1) @ H.T
    x2 = p[..., :2] / p[..., 2:] + rng.normal(scale=1e-4, size=x1.shape)
    x1, x2 = x1.astype(np.float32), x2.astype(np.float32)
    rH, rv = js.solve_homography(jnp.asarray(x1), jnp.asarray(x2))
    oH, ov = ts.solve_homography(t(x1), t(x2))
    np.testing.assert_array_equal(n(ov), np.asarray(rv))
    _assert_models_covered(np.asarray(rH)[:, None], np.asarray(rv)[:, None],
                           n(oH)[:, None], n(ov)[:, None])
    # transfer residual |x2 - H x1| of the same models within 1e-6: it is
    # a cancellation of O(1) coordinates, so it agrees to a few ulp of
    # those, in absolute terms
    err_r = np.asarray(js.homography_transfer_error(
        rH[:, None], jnp.asarray(x1), jnp.asarray(x2)))
    err_o = n(ts.homography_transfer_error(t(rH)[:, None], t(x1), t(x2)))
    np.testing.assert_allclose(np.sqrt(err_o), np.sqrt(err_r), rtol=0,
                               atol=1e-6)


def test_building_blocks_match():
    rng = np.random.default_rng(4)
    A = rng.normal(size=(32, 5, 9)).astype(np.float32)
    ref = np.asarray(js.nullspace_qr(jnp.asarray(A)))
    out = n(ts.nullspace_qr(t(A)))
    np.testing.assert_allclose(out, ref, atol=1e-5)
    M = rng.normal(size=(32, 10, 10)).astype(np.float32)
    B = rng.normal(size=(32, 10, 10)).astype(np.float32)
    np.testing.assert_allclose(
        n(ts.solve_small_lanes(t(M), t(B))),
        np.asarray(js.solve_small_lanes(jnp.asarray(M), jnp.asarray(B))),
        rtol=1e-3, atol=1e-3)
    E = rng.normal(size=(32, 3, 3)).astype(np.float32)
    np.testing.assert_allclose(n(ts.det3(t(E))),
                               np.asarray(js.det3(jnp.asarray(E))), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(n(ts._adjugate_t(t(E))),
                               np.asarray(js._adjugate_t(jnp.asarray(E))),
                               rtol=1e-5, atol=1e-6)
    x1 = rng.normal(size=(7, 2)).astype(np.float32)
    x2 = rng.normal(size=(7, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        n(ts.epipolar_rows(t(x1), t(x2))),
        np.asarray(js.epipolar_rows(jnp.asarray(x1), jnp.asarray(x2))))
    np.testing.assert_array_equal(
        n(ts.homography_rows(t(x1), t(x2))),
        np.asarray(js.homography_rows(jnp.asarray(x1), jnp.asarray(x2))))
    # ordinary nullspace of A^T A: sign-invariant
    rN = np.asarray(js.nullspace_from_ata(jnp.asarray(A[0]), 1))[:, 0]
    oN = n(ts.nullspace_from_ata(t(A[0]), 1))[:, 0]
    assert min(np.abs(rN - oN).max(), np.abs(rN + oN).max()) < 1e-4


def test_real_roots_poly10():
    """Polynomials with 2..6 planted real roots: the valid roots agree."""
    rng = np.random.default_rng(5)
    polys = []
    for _ in range(16):
        r = rng.uniform(-3, 3, rng.integers(2, 7))
        c = np.poly1d(r, r=True) * np.poly1d(
            rng.normal(size=11 - len(r)) ** 2 + 0.5)
        a = np.zeros(11)
        a[: len(c.coeffs)] = c.coeffs[::-1][:11]
        polys.append(a)
    a = np.stack(polys).astype(np.float32)
    rr, rv = js._real_roots_poly10(jnp.asarray(a))
    orr, ov = ts._real_roots_poly10(t(a))
    rr, rv, orr, ov = np.asarray(rr), np.asarray(rv), n(orr), n(ov)
    for b in range(16):
        for z in rr[b][rv[b]]:
            assert np.min(np.abs(orr[b][ov[b]] - z)) < 1e-4 * (1 + abs(z))
