"""Port parity: pyramidal LK flow and the LKOF / ALKOF / LKOFT matchers,
against the JAX package on the CPU.

The four cases of tests/test_optflow.py (``lk_texture`` at 128 x 160 and
96 x 128, planted shifts). Tolerances: predicted positions within 0.02 px
on >= 99% of the points and the status equal on >= 99% (the gates
``|step|^2 < eps^2`` and ``err < max_err`` are branches on float32 sums
that XLA adds in an order of its own: a flip moves a point by at most one
step of <= eps, or flips its status); match slots kept by both packages
name the same keypoint at the same distance (Hamming exactly; LKOF's
squared pixels, from |a|^2 + |b|^2 - 2 a.b in float32, within 0.02, a
few ulps of the ~3e4 px^2 terms), and the kept masks agree on >= 99%.
``lk_flow`` reads nothing on the host (``HostSyncs``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from matchinglib_poselib_tpu.ops import optflow as jof
from matchinglib_poselib_torch.ops import optflow as tof
from matchinglib_poselib_torch.utils.profiling import HostSyncs

from test_optflow import lk_texture
from test_torch_helpers import n, t

FLOW_ATOL = 0.02
AGREE = 0.99


def _check_flow(ft, fj):
    d = np.abs(n(ft.pts) - np.asarray(fj.pts)).max(axis=1)
    assert (d <= FLOW_ATOL).mean() >= AGREE, d.max()
    assert (n(ft.status) == np.asarray(fj.status)).mean() >= AGREE


def _check_matches(rt, rj, dist_atol=0.0):
    mt, mj = n(rt.mask), np.asarray(rj.mask)
    assert (mt == mj).mean() >= AGREE
    both = mt & mj
    assert both.sum() > 0
    np.testing.assert_array_equal(n(rt.idx)[both], np.asarray(rj.idx)[both])
    np.testing.assert_allclose(n(rt.distance)[both],
                               np.asarray(rj.distance)[both], atol=dist_atol)


@pytest.mark.parametrize("n_pts", [48, 300])
def test_lk_flow_large_shift(n_pts):
    rng = np.random.default_rng(42)
    dx, dy = 6.0, -4.0
    img1 = lk_texture(128, 160)
    img2 = lk_texture(128, 160, dx=dx, dy=dy)
    pts = np.stack([rng.uniform(25, 135, n_pts), rng.uniform(25, 100, n_pts)],
                   axis=1).astype(np.float32)
    mask = rng.random(n_pts) < 0.9
    fj = jof.lk_flow(jnp.asarray(img1), jnp.asarray(img2), jnp.asarray(pts),
                     jnp.asarray(mask))
    before = HostSyncs.count
    ft = tof.lk_flow(t(img1), t(img2), t(pts), torch.tensor(mask))
    assert HostSyncs.count == before
    _check_flow(ft, fj)
    ok = n(ft.status)
    assert ok.mean() > 0.8 * mask.mean()
    err = np.abs(n(ft.pts)[ok] - (pts[ok] + [dx, dy]))
    assert np.median(err) < 0.25


def test_gaussian_pyramid():
    img = lk_texture(97, 131)
    pj = jof.gaussian_pyramid(jnp.asarray(img), 3)
    pt = tof.gaussian_pyramid(t(img), 3)
    for a, b in zip(pt, pj):
        assert a.shape == b.shape
        np.testing.assert_allclose(n(a), np.asarray(b), atol=1e-6)


def test_lkof_matches():
    rng = np.random.default_rng(42)
    dx, dy = 3.0, 2.0
    img1 = lk_texture(128, 160)
    img2 = lk_texture(128, 160, dx=dx, dy=dy)
    n_pts = 40
    kp1 = np.stack([rng.uniform(25, 135, n_pts), rng.uniform(25, 100, n_pts)],
                   axis=1).astype(np.float32)
    perm = rng.permutation(n_pts)
    kp2 = (kp1 + [dx, dy])[perm].astype(np.float32)
    ones = np.ones(n_pts, bool)
    rj = jof.match_lkof(jnp.asarray(kp1), jnp.asarray(kp2), jnp.asarray(ones),
                        jnp.asarray(ones), jnp.asarray(img1),
                        jnp.asarray(img2), search_radius=5.0)
    rt = tof.match_lkof(t(kp1), t(kp2), torch.tensor(ones),
                        torch.tensor(ones), t(img1), t(img2),
                        search_radius=5.0)
    # squared px from |a|^2 + |b|^2 - 2 a.b: a few f32 ulps of ~3e4 px^2
    _check_matches(rt, rj, dist_atol=0.02)
    m = n(rt.mask)
    assert m.mean() > 0.8
    assert (n(rt.idx)[m] == np.argsort(perm)[m]).mean() > 0.95


def test_alkof_rejects_wrong_descriptors():
    rng = np.random.default_rng(42)
    dx = 3.0
    img1 = lk_texture(96, 128)
    img2 = lk_texture(96, 128, dx=dx)
    n_pts = 24
    kp1 = np.stack([rng.uniform(20, 105, n_pts), rng.uniform(20, 72, n_pts)],
                   axis=1).astype(np.float32)
    kp2 = np.concatenate([kp1 + [dx, 0.0], kp1 + [dx + 2.0, 0.0]]).astype(
        np.float32)
    desc1 = rng.integers(0, 2**32, (n_pts, 8), dtype=np.uint32)
    noise = (rng.integers(0, 2**32, (n_pts, 8), dtype=np.uint32)
             & rng.integers(0, 2**32, (n_pts, 8), dtype=np.uint32)
             & rng.integers(0, 2**32, (n_pts, 8), dtype=np.uint32))
    desc2 = np.concatenate(
        [desc1 ^ noise, rng.integers(0, 2**32, (n_pts, 8), dtype=np.uint32)])
    rj = jof.match_alkof(
        jnp.asarray(kp1), jnp.asarray(kp2), jnp.asarray(desc1),
        jnp.asarray(desc2), jnp.ones(n_pts, bool), jnp.ones(2 * n_pts, bool),
        jnp.asarray(img1), jnp.asarray(img2), search_radius=6.0,
        max_hamm=80.0)
    rt = tof.match_alkof(
        t(kp1), t(kp2), t(desc1.view(np.int32)), t(desc2.view(np.int32)),
        torch.ones(n_pts, dtype=torch.bool),
        torch.ones(2 * n_pts, dtype=torch.bool), t(img1), t(img2),
        search_radius=6.0, max_hamm=80.0)
    _check_matches(rt, rj)
    m = n(rt.mask)
    assert m.mean() > 0.8
    assert (n(rt.idx)[m] == np.arange(n_pts)[m]).all()


def test_lkoft_tracker_status():
    img1 = lk_texture(96, 128)
    img2 = lk_texture(96, 128, dx=2.0)
    kp = np.array([[40.0, 40.0], [80.0, 50.0], [126.0, 94.0]], np.float32)
    fj = jof.track_lkoft(jnp.asarray(kp), jnp.ones(3, bool),
                         jnp.asarray(img1), jnp.asarray(img2))
    ft = tof.track_lkoft(t(kp), torch.ones(3, dtype=torch.bool), t(img1),
                         t(img2))
    assert np.array_equal(n(ft.status), np.asarray(fj.status))
    assert np.abs(n(ft.pts) - np.asarray(fj.pts)).max() <= FLOW_ATOL
    st = n(ft.status)
    assert st[0] and st[1]
    assert np.abs(n(ft.pts)[:2] - (kp[:2] + [2.0, 0.0])).max() < 0.3
