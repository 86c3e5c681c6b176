"""The match filters and sub-pixel refinement, port vs JAX package:
``filters.sof_filter_matches``, ``subpix.refine_matches_subpix``,
``filters.vfc_filter`` and the filter chain of ``get_correspondences``.

- SOF filter, on a three-plane disparity field with 20% outliers and
  invalid slots: masks equal on every slot whose distance to the
  predicted position is more than 1e-3 px from the predicted radius (the
  field's medians are exact; the bilinear prediction is a few f32 ulp
  apart).
- Sub-pixel refinement, on a textured image shifted by (0.3, -0.7) px:
  shifts within 1e-4 px on >= 99% of the valid slots (XLA's convolution
  sums its taps in another order, which can move the integer argmin of an
  SSD near-tie), ``success`` equal wherever the shifts agree (>= 99% of
  the slots) and ``pass_ok`` equal; a right
  image without texture fails the pass on both sides and leaves pts2 as
  it was.
- VFC, NORMAL (every point a basis) and SPARSE (64 bases), 512 slots:
  masks equal on >= 99% of the slots, probabilities within 5e-4
  (measured 5.1e-5 NORMAL, 8.2e-6 SPARSE; the EM system is
  ill-conditioned in f32: Gram entries of unit-scaled points lie in
  [0.82, 1], and 2048 slots moved them by up to 1.5e-3).
- ``get_correspondences`` at 240x480 / 512 slots with each option
  (``sof_filter`` with the FLANN matcher, ``subpix_refine``,
  ``vfc_filter``, the last two together, and all three), against the JAX
  function slot by slot: masks and qualities equal, pts2 within 1e-4 px
  where both keep.
- ``run_batch`` with each option, with subpix + VFC and with all three,
  each pair equal to ``run`` (test_torch_run_batch.py (c)'s bars), P = 3.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from matchinglib_poselib_tpu import config as jcfg
from matchinglib_poselib_tpu.models import pipeline as jp
from matchinglib_poselib_tpu.ops import filters as jf
from matchinglib_poselib_tpu.ops import subpix as jsp

from matchinglib_poselib_torch import config as tcfg
from matchinglib_poselib_torch.models import pipeline as tp
from matchinglib_poselib_torch.ops import filters as tf
from matchinglib_poselib_torch.ops import subpix as tsp

from chip_smoke import render_scene
from test_torch_helpers import (
    assert_pair_equal, jax_pair_streams, n, t, textured_image,
)
from test_torch_run_batch import FAST

H, W = 240, 480
VFC_PROB_TOL = 5e-4
SUBPIX_TOL = 1e-4
SLOT_SHARE = 0.99


def _planes_flow(seed, n_pts, outliers=0.2, invalid=0.1):
    """pts1, pts2 (pixels), mask: a three-plane disparity field (x
    shifts 12, 24 and 40 px by vertical band, small y drift), a share of
    outliers moved anywhere, a share of invalid slots."""
    rng = np.random.default_rng(seed)
    pts1 = np.stack([rng.uniform(5, W - 5, n_pts),
                     rng.uniform(5, H - 5, n_pts)], -1)
    band = np.digitize(pts1[:, 1], [H / 3, 2 * H / 3])
    flow = np.stack([np.choose(band, [12.0, 24.0, 40.0])
                     + 0.02 * pts1[:, 0], 0.01 * pts1[:, 1] - 1.0], -1)
    pts2 = pts1 + flow + rng.normal(scale=0.3, size=(n_pts, 2))
    out = rng.random(n_pts) < outliers
    pts2[out] = np.stack([rng.uniform(0, W, out.sum()),
                          rng.uniform(0, H, out.sum())], -1)
    mask = rng.random(n_pts) >= invalid
    return pts1.astype(np.float32), pts2.astype(np.float32), mask


# ---------------------------------------------------------------------------
# the SOF consistency filter
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed, vth", [(0, 0.3), (1, 0.5)])
def test_sof_filter_matches_matches_jax(seed, vth):
    p1, p2, m = _planes_flow(seed, 1024)
    want = np.asarray(jf.sof_filter_matches(
        jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(m), (H, W),
        cell_px=100, validation_th=vth))
    got = n(tf.sof_filter_matches(t(p1), t(p2), torch.from_numpy(m), (H, W),
                                  cell_px=100, validation_th=vth))
    field = jf.sof_statistics(jnp.asarray(p1), jnp.asarray(p2),
                              jnp.asarray(m), (H, W), 100, vth)
    pred, rad = jf.sof_predict(field, jnp.asarray(p1), 100)
    d = np.linalg.norm(p2 - np.asarray(pred), axis=-1)
    clear = np.abs(d - np.asarray(rad)) > 1e-3
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(got[clear], want[clear])
    # the filter removes the outliers and keeps most inliers
    assert 0.5 * m.sum() < want.sum() < m.sum()


# ---------------------------------------------------------------------------
# sub-pixel refinement
# ---------------------------------------------------------------------------


def _shifted_pair(seed, shift):
    """A textured image and the same image moved by `shift` (dx, dy) px
    (bilinear), and 400 match slots: pts1 inside the image, pts2 = pts1 +
    shift + up to 1.5 px of error, 10% invalid."""
    rng = np.random.default_rng(seed)
    img1 = textured_image(rng, H, W)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    sx, sy = np.clip(xx - shift[0], 0, W - 1.001), np.clip(yy - shift[1], 0,
                                                          H - 1.001)
    x0, y0 = np.floor(sx).astype(int), np.floor(sy).astype(int)
    fx, fy = sx - x0, sy - y0
    img2 = (img1[y0, x0] * (1 - fx) * (1 - fy) + img1[y0, x0 + 1] * fx
            * (1 - fy) + img1[y0 + 1, x0] * (1 - fx) * fy
            + img1[y0 + 1, x0 + 1] * fx * fy)
    pts1 = np.stack([rng.uniform(10, W - 10, 400),
                     rng.uniform(10, H - 10, 400)], -1)
    pts2 = pts1 + shift + rng.uniform(-1.5, 1.5, (400, 2))
    mask = rng.random(400) >= 0.1
    return (img1.astype(np.float32), img2.astype(np.float32),
            pts1.astype(np.float32), pts2.astype(np.float32), mask)


def _subpix_both(seed, shift, flat=False):
    i1, i2, p1, p2, m = _shifted_pair(seed, shift)
    if flat:
        i2 = np.full_like(i2, 0.5)
    want = jsp.refine_matches_subpix(jnp.asarray(i1), jnp.asarray(i2),
                                     jnp.asarray(p1), jnp.asarray(p2),
                                     jnp.asarray(m))
    got = tsp.refine_matches_subpix(t(i1), t(i2), t(p1), t(p2),
                                    torch.from_numpy(m))
    return want, got, p1, p2, m


def test_refine_matches_subpix_matches_jax():
    want, got, p1, p2, m = _subpix_both(2, (0.3, -0.7))
    assert bool(want.pass_ok) and bool(got.pass_ok)
    close = np.abs(n(got.shift) - np.asarray(want.shift)).max(-1) <= (
        SUBPIX_TOL)
    assert close[m].mean() >= SLOT_SHARE, close[m].mean()
    # success equal wherever the SSD minimum is the same one; a near-tie
    # that moves the minimum can move it to the window's border
    np.testing.assert_array_equal(n(got.success)[close],
                                  np.asarray(want.success)[close])
    assert (n(got.success) == np.asarray(want.success)).mean() >= SLOT_SHARE
    moved = np.abs(n(got.pts2) - np.asarray(want.pts2)).max(-1)
    assert (moved[m] <= SUBPIX_TOL).mean() >= SLOT_SHARE
    # the refined points move toward the true shift
    ok = n(got.success)
    truth = p1[ok] + np.float32([0.3, -0.7])
    assert np.median(np.abs(n(got.pts2)[ok] - truth)) < 0.5 * np.median(
        np.abs(p2[ok] - truth))
    assert ok.sum() > 0.8 * m.sum()


def test_refine_matches_subpix_rejects_the_pass():
    """A right image without texture: no SSD surface has contrast, no
    match succeeds, the pass fails on both sides and pts2 stays."""
    want, got, p1, p2, m = _subpix_both(3, (0.3, -0.7), flat=True)
    assert not bool(want.pass_ok) and not bool(got.pass_ok)
    np.testing.assert_array_equal(n(got.success), np.asarray(want.success))
    np.testing.assert_array_equal(n(got.pts2), p2)


# ---------------------------------------------------------------------------
# VFC
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_basis", [0, 64])
def test_vfc_filter_matches_jax(n_basis):
    p1, p2, m = _planes_flow(4, 512, outliers=0.15)
    scale = np.float32([W, H])
    want = jf.vfc_filter(jnp.asarray(p1 / scale), jnp.asarray(p2 / scale),
                         jnp.asarray(m), n_basis=n_basis)
    got = tf.vfc_filter(t(p1 / scale), t(p2 / scale), torch.from_numpy(m),
                        n_basis=n_basis)
    wm, gm = np.asarray(want.inlier_mask), n(got.inlier_mask)
    assert (wm == gm).mean() >= SLOT_SHARE
    np.testing.assert_allclose(n(got.probabilities),
                               np.asarray(want.probabilities), rtol=0,
                               atol=VFC_PROB_TOL)
    # the field separates the outliers
    assert 0.6 * m.sum() < wm.sum() < 0.95 * m.sum()


# ---------------------------------------------------------------------------
# the filter chain of get_correspondences
# ---------------------------------------------------------------------------

CHAIN = {
    "sof_filter": dict(matcher_name="FLANN", sof_filter=True),
    "subpix": dict(subpix_refine=True),
    "vfc": dict(vfc_filter=True),
    "subpix_vfc": dict(subpix_refine=True, vfc_filter=True),
    "all": dict(matcher_name="FLANN", sof_filter=True, subpix_refine=True,
                vfc_filter=True),
}


@pytest.mark.parametrize("option", sorted(CHAIN))
def test_get_correspondences_options_match_jax(option):
    img1, img2, _, _, _ = render_scene(0, W, H)
    det = dict(FAST)
    jc = jp.get_correspondences(
        jnp.asarray(img1), jnp.asarray(img2), jcfg.DetectorConfig(**det),
        jcfg.DescriptorConfig(), jcfg.MatchingConfig(**CHAIN[option]))
    tc = tp.get_correspondences(
        t(img1), t(img2), tcfg.DetectorConfig(**det), tcfg.DescriptorConfig(),
        tcfg.MatchingConfig(**CHAIN[option]))
    jm, tm = np.asarray(jc.mask), n(tc.mask)
    np.testing.assert_array_equal(tm, jm)
    assert jm.sum() >= 100
    np.testing.assert_array_equal(n(tc.quality), np.asarray(jc.quality))
    np.testing.assert_allclose(n(tc.pts2)[jm], np.asarray(jc.pts2)[jm],
                               rtol=0, atol=SUBPIX_TOL)
    np.testing.assert_array_equal(n(tc.pts1), np.asarray(jc.pts1))


@pytest.mark.parametrize("option", ["sof_filter", "subpix", "vfc",
                                    "subpix_vfc", "all"])
def test_run_batch_match_options_match_run_per_pair(option):
    scenes = [render_scene(s, W, H) for s in (0, 1, 2)]
    imgs1 = np.stack([s[0] for s in scenes])
    imgs2 = np.stack([s[1] for s in scenes])
    K = scenes[0][2]
    pipe = tp.StereoPipeline(
        tcfg.DetectorConfig(**FAST), tcfg.DescriptorConfig(),
        tcfg.MatchingConfig(**CHAIN[option]),
        tcfg.PoseConfig(robust=tcfg.RobustConfig(batch_hypotheses=64,
                                                 max_batches=4)),
        device="cpu")
    args = (t(K), t(K), torch.zeros(5), torch.zeros(5))
    U, D = jax_pair_streams(jax.random.PRNGKey(6), 3, pipe.pose_cfg.robust)
    corr, pose = pipe.run_batch(imgs1, imgs2, *args, uniforms=U,
                                degen_uniforms=D)
    for i in range(3):
        c, p = pipe.run(imgs1[i], imgs2[i], *args, uniforms=U[i],
                        degen_uniforms=D[i])
        assert_pair_equal(corr, pose, c, p, i)
