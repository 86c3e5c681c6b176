"""GMS and GMBSOF statistical-flow filters: port vs JAX package.

Tolerances: gms_filter bit-exact (cell counts are sums of 0/1; the cell
coordinates follow the JAX package's compiled arithmetic); sof_statistics,
sof_predict and sof_predict_knn within atol 1e-4 (per-cell means and
standard deviations are f32 segment sums taken in another order; medians
and validity are order-free); sof_cell_valid_at and
select_strongest_per_cell exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from matchinglib_poselib_tpu.ops import filters as jf

from matchinglib_poselib_torch.ops import filters as tf

from test_torch_helpers import n, t

SHAPE = (240, 480)
CELL = 100


def _matches(seed, n_pts=400, outliers=0.3, sparse=False):
    """Smooth flow field (stereo-like disparity + drift) + outliers."""
    rng = np.random.default_rng(seed)
    p1 = np.stack([rng.uniform(0, SHAPE[1], n_pts),
                   rng.uniform(0, SHAPE[0], n_pts)], 1)
    flow = np.stack([-12.0 - 0.03 * p1[:, 0] + 0.02 * p1[:, 1],
                     0.5 + 0.01 * p1[:, 0]], 1)
    p2 = p1 + flow + rng.normal(scale=0.7, size=p1.shape)
    out = rng.random(n_pts) < outliers
    p2[out] = np.stack([rng.uniform(0, SHAPE[1], out.sum()),
                        rng.uniform(0, SHAPE[0], out.sum())], 1)
    mask = rng.random(n_pts) < (0.08 if sparse else 0.9)
    return (p1.astype(np.float32), p2.astype(np.float32), mask,
            rng.uniform(0.01, 1.0, n_pts).astype(np.float32))


def _compare_field(ref, out):
    np.testing.assert_array_equal(n(out.valid), np.asarray(ref.valid))
    np.testing.assert_allclose(n(out.flow), np.asarray(ref.flow), atol=1e-4)
    np.testing.assert_allclose(n(out.radius), np.asarray(ref.radius),
                               atol=1e-4)


@pytest.mark.parametrize("vth", [0.3, 0.6])
def test_sof_statistics_and_predict(vth):
    p1, p2, m, _ = _matches(1)
    ref = jf.sof_statistics(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(m),
                            SHAPE, cell_px=CELL, validation_th=vth)
    out = tf.sof_statistics(t(p1), t(p2), torch.from_numpy(m), SHAPE,
                            cell_px=CELL, validation_th=vth)
    _compare_field(ref, out)
    assert np.asarray(ref.valid).sum() >= 3
    q = np.random.default_rng(2).uniform(0, 480, (300, 2)).astype(np.float32)
    q[:, 1] *= 0.5
    rp, rr = jf.sof_predict(ref, jnp.asarray(q), CELL)
    op, orr = tf.sof_predict(out, t(q), CELL)
    np.testing.assert_allclose(n(op), np.asarray(rp), atol=1e-4)
    np.testing.assert_allclose(n(orr), np.asarray(rr), atol=1e-4)
    np.testing.assert_array_equal(
        n(tf.sof_cell_valid_at(out, t(q), CELL)),
        np.asarray(jf.sof_cell_valid_at(ref, jnp.asarray(q), CELL)))


def test_sof_statistics_autoth_threshold_and_sparse_seeds():
    """A traced AUTOTH threshold, and a seed set too sparse for any cell
    (the field falls back to its 1e6 radius everywhere)."""
    for r in (0.1, 0.3, 0.5):
        np.testing.assert_allclose(
            n(tf.autoth_validation_th(torch.tensor(r), True)),
            np.asarray(jf.autoth_validation_th(jnp.asarray(r), True)),
            atol=0)
        np.testing.assert_allclose(
            n(tf.autoth_validation_th(torch.tensor(r), False)),
            np.asarray(jf.autoth_validation_th(jnp.asarray(r), False)),
            atol=0)
    p1, p2, m, _ = _matches(3, sparse=True)
    vth = tf.autoth_validation_th(torch.tensor(0.2), True)
    ref = jf.sof_statistics(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(m),
                            SHAPE, cell_px=CELL,
                            validation_th=jnp.asarray(float(vth)))
    out = tf.sof_statistics(t(p1), t(p2), torch.from_numpy(m), SHAPE,
                            cell_px=CELL, validation_th=vth)
    _compare_field(ref, out)


@pytest.mark.parametrize("seed", [4, 5])
def test_sof_predict_knn(seed):
    p1, p2, m, _ = _matches(seed, sparse=seed == 5)
    q = np.random.default_rng(seed + 10).uniform(0, 240, (256, 2)).astype(
        np.float32)
    ref = jf.sof_predict_knn(jnp.asarray(p1), jnp.asarray(p2 - p1),
                             jnp.asarray(m), jnp.asarray(q))
    out = tf.sof_predict_knn(t(p1), t(p2 - p1), torch.from_numpy(m), t(q))
    np.testing.assert_array_equal(n(out[2]), np.asarray(ref[2]))
    ok = np.asarray(ref[2])
    np.testing.assert_allclose(n(out[0])[ok], np.asarray(ref[0])[ok],
                               atol=1e-4)
    np.testing.assert_allclose(n(out[1])[ok], np.asarray(ref[1])[ok],
                               atol=1e-4)


def test_select_strongest_per_cell_exact():
    p1, _, m, resp = _matches(6, n_pts=600)
    resp[::7] = resp[3]  # planted response ties
    ref = jf.select_strongest_per_cell(
        jnp.asarray(p1), jnp.asarray(resp), jnp.asarray(m), SHAPE,
        cell_px=CELL, per_cell=16)
    out = tf.select_strongest_per_cell(
        t(p1), t(resp), torch.from_numpy(m), SHAPE, cell_px=CELL,
        per_cell=16)
    np.testing.assert_array_equal(n(out), np.asarray(ref))
    assert 0 < n(out).sum() < m.sum()


def _gms_matches(seed, n_pts=600):
    """Clusters of consistent motion (stereo-like shift, per-cluster
    jitter) at random places, plus random outliers, ~8% masked."""
    rng = np.random.default_rng(seed)
    centers = np.stack([rng.uniform(0, SHAPE[1], 40),
                        rng.uniform(0, SHAPE[0], 40)], 1)
    which = rng.integers(0, 40, n_pts)
    p1 = centers[which] + rng.normal(scale=9.0, size=(n_pts, 2))
    p2 = p1 + np.array([-14.0, 1.0]) + rng.normal(scale=1.5, size=(n_pts, 2))
    out = rng.random(n_pts) < 0.25
    p2[out] = np.stack([rng.uniform(0, SHAPE[1], out.sum()),
                        rng.uniform(0, SHAPE[0], out.sum())], 1)
    p1 = np.clip(p1, 0, [SHAPE[1] - 1, SHAPE[0] - 1])
    p2 = np.clip(p2, 0, [SHAPE[1] - 1, SHAPE[0] - 1])
    mask = rng.random(n_pts) > 0.08
    return p1.astype(np.float32), p2.astype(np.float32), mask


@pytest.mark.parametrize("grid", [20, 12])
def test_gms_filter_bit_exact(grid):
    p1, p2, m = _gms_matches(3 + grid)
    ref = np.asarray(jf.gms_filter(jnp.asarray(p1), jnp.asarray(p2),
                                   jnp.asarray(m), SHAPE, SHAPE, grid=grid))
    out = n(tf.gms_filter(t(p1), t(p2), torch.from_numpy(m), SHAPE, SHAPE,
                          grid=grid))
    np.testing.assert_array_equal(out, ref)
    assert 30 < ref.sum() < m.sum()


def test_gms_filter_every_offset_matters():
    """A set where each of the 4 half-cell grids accepts a match that no
    other grid accepts, so dropping any offset would change the result;
    the port still equals the JAX package bit for bit."""
    p1, p2, m = _gms_matches(5, n_pts=900)
    acc = [n(tf.gms_offset_accept(t(p1), t(p2), torch.from_numpy(m), SHAPE,
                                  SHAPE, 20, 6.0, ox, oy)) & m
           for ox, oy in tf.GMS_OFFSETS]
    for i, a in enumerate(acc):
        others = np.any([b for j, b in enumerate(acc) if j != i], axis=0)
        assert (a & ~others).any(), f"offset {tf.GMS_OFFSETS[i]} adds none"
    ref = np.asarray(jf.gms_filter(jnp.asarray(p1), jnp.asarray(p2),
                                   jnp.asarray(m), SHAPE, SHAPE))
    np.testing.assert_array_equal(
        n(tf.gms_filter(t(p1), t(p2), torch.from_numpy(m), SHAPE, SHAPE)),
        ref)
    np.testing.assert_array_equal(ref, np.any(acc, axis=0))
