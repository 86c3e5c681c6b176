"""The detector rows beyond FAST, SIFT and SURF: port vs JAX package.

Inputs: a textured 240x480 image (``textured_image``) and the synthetic
scene at 240x480 (``chip_smoke.render_scene``), made from seeds.

Tolerances:
- Harris response: exact (the same f32 operations in the same order).
  Shi-Tomasi: atol 1e-6 (measured 4.8e-7: its square root of a
  difference rounds apart where XLA fuses the products).
- ``box_filter``: atol 1e-6, as ``gaussian_blur`` (XLA's convolution sums
  the taps in another order).
- STAR, MSD, MSER and pyramid ORB / BRISK keypoints: >= 99% of the
  keypoints valid on either side found on the other at the same position
  (xy within 1e-4; measured 100%), aligned by position as the SIFT test
  does (an extremum on an f32 near tie flips with an ulp); MSER on the
  scene >= 98.5% (measured 98.99%: 2 of 199 DoG extrema flip).
- The resize weights: within two f32 ulps of 1 (1.2e-7) of the JAX
  package's compiled ``compute_weight_mat``, equal on all but < 0.5% of
  the entries (measured 8.9e-8 and 0.27% at 320 -> 164: XLA sums each
  column in another order); the resized image within 4e-7 (measured
  3.6e-7).
- Pyramid FAST through the kernel's route: with the fused kernel's own
  border (the plain version of the zero-padded input), the keypoints equal
  the JAX package's slot for slot.
- ``_kcontrast``: rtol 1e-6 (measured one ulp: the percentile's sort
  picks a neighbour when a blurred gradient rounds apart).
- KAZE levels: atol 1e-6 after 186 explicit diffusion steps (measured
  1.8e-7); against a float64 run of the same steps the port's f32 levels
  are within 2x the JAX package's own error (measured: both within
  1.8e-7 of it, the port's at most 1.3x the JAX package's). KAZE
  keypoints by position against the compiled JAX detector: >= 99% on the
  textured image (measured 100%), >= 96% on the scene (measured 96.7%, 8
  keypoints flip): the sigma^4-scaled Hessian determinant of the coarse
  levels is a difference of products that turns 1e-7 level differences
  into 4e-4 relative score differences, so near-equal extrema across
  levels flip (ROADMAP C).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from matchinglib_poselib_tpu.ops import features as jfeat
from matchinglib_poselib_tpu.ops import nonlinear_diffusion as jnd
from matchinglib_poselib_tpu.ops import scale_space as js

from matchinglib_poselib_torch.ops import features as tfeat
from matchinglib_poselib_torch.ops import nonlinear_diffusion as tnd
from matchinglib_poselib_torch.ops import scale_space as ts
from matchinglib_poselib_torch.ops.kernels import fast_nms

from chip_smoke import render_scene
from test_torch_helpers import (
    align_slots, aligned_fraction, n, t, textured_image,
)

THR = 12.0 / 255.0


def _image(name):
    if name == "scene":
        return render_scene(0, 480, 240)[0]
    return textured_image(np.random.default_rng(21), 240, 480)


def _aligned(ref, out):
    jm, tm = np.asarray(ref.mask), n(out.mask)
    perm = align_slots(ref.xy, jm, n(out.xy), tm)
    return aligned_fraction(perm, jm, tm)


@pytest.mark.parametrize("name,atol", [("harris_score", 0.0),
                                       ("shi_tomasi_score", 1e-6)])
def test_corner_scores_match_jax(name, atol):
    img = _image("textured")
    ref = np.asarray(getattr(jfeat, name)(jnp.asarray(img)))
    out = n(getattr(tfeat, name)(t(img)))
    np.testing.assert_allclose(out, ref, rtol=0, atol=atol)
    gx, gy = jfeat._sobel(jnp.asarray(img))
    tgx, tgy = tfeat.sobel(t(img))
    np.testing.assert_array_equal(n(tgx), np.asarray(gx))
    np.testing.assert_array_equal(n(tgy), np.asarray(gy))


@pytest.mark.parametrize("radius", [2, 3, 11])
def test_box_filter_matches_jax(radius):
    img = _image("textured")
    ref = np.asarray(js.box_filter(jnp.asarray(img), radius))
    np.testing.assert_allclose(n(ts.box_filter(t(img), radius)), ref,
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("detector", ["censure_keypoints", "msd_keypoints",
                                      "mser_blob_keypoints"])
@pytest.mark.parametrize("image", ["textured", "scene"])
def test_blob_and_saliency_keypoints_match_jax(detector, image):
    img = _image(image)
    ref = getattr(js, detector)(jnp.asarray(img), 256)
    out = getattr(ts, detector)(t(img), 256)
    assert out.xy.shape == (256, 2)
    frac, flipped = _aligned(ref, out)
    # MSER on the scene: 2 of 199 flip (98.99%), DoG near ties as SIFT's
    budget = 0.985 if (detector, image) == ("mser_blob_keypoints",
                                            "scene") else 0.99
    assert frac >= budget, f"{flipped} keypoints differ ({frac:.4f})"
    assert np.asarray(ref.mask).sum() > 50
    np.testing.assert_array_equal(ts._msd_offsets(), js._msd_offsets())


@pytest.mark.parametrize("size", [(512, 410), (1392, 1114), (512, 262),
                                  (1392, 713), (240, 192), (320, 164)])
def test_resize_weights_match_compute_weight_mat(size):
    from jax._src.image import scale as jscale

    i, o = size
    ref = np.asarray(jax.jit(lambda: jscale.compute_weight_mat(
        i, o, o / i, 0.0, jscale._fill_triangle_kernel, True))())
    out = n(ts.resize_weights(i, o))
    assert out.dtype == np.float32 and out.shape == (i, o)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1.2e-7)
    assert (out != ref).mean() < 5e-3


def test_resize_linear_matches_jax_image_resize():
    img = _image("scene")
    for s in (1.25, 1.5625, 1.953125):
        nh, nw = int(round(240 / s)), int(round(480 / s))
        ref = np.asarray(jax.image.resize(jnp.asarray(img), (nh, nw),
                                          "linear"))
        out = n(ts.resize_linear(t(img), nh, nw))
        np.testing.assert_allclose(out, ref, rtol=0, atol=4e-7)


def _kernel_border(imgs, threshold, radius):
    """What the fused kernel computes on the card: the plain version of the
    input zero-padded by 3 + radius, cropped back (chip_smoke.py phase
    2's reference)."""
    p = 3 + radius
    padded = torch.nn.functional.pad(imgs, (p, p, p, p))
    return fast_nms.fast_nms_score_plain(padded, threshold,
                                         radius)[:, p:-p, p:-p]


@pytest.mark.parametrize("harris_rank", [True, False])
@pytest.mark.parametrize("image", ["textured", "scene"])
def test_pyramid_fast_matches_jax(harris_rank, image, monkeypatch):
    """ORB (Harris re-rank) and BRISK at 4 levels: the CPU path, and the
    kernel's route (its zero border instead of the wrapped ring), give the
    JAX package's keypoints; each level is one call of the wrapper."""
    img = _image(image)
    ref = js.pyramid_fast_keypoints(jnp.asarray(img), 256, THR, n_levels=4,
                                    harris_rank=harris_rank)
    out = ts.pyramid_fast_keypoints(t(img), 256, THR, n_levels=4,
                                    harris_rank=harris_rank)
    frac, flipped = _aligned(ref, out)
    assert frac >= 0.99, f"{flipped} keypoints differ"
    calls = []

    def kernel_route(imgs, threshold, radius=3):
        calls.append((tuple(imgs.shape), radius))
        return _kernel_border(imgs, threshold, radius)

    monkeypatch.setattr(fast_nms, "fast_nms_score", kernel_route)
    out_k = ts.pyramid_fast_keypoints(t(img), 256, THR, n_levels=4,
                                      harris_rank=harris_rank)
    for a, b in zip(out_k, out):
        assert torch.equal(a, b)
    assert [r for _, r in calls] == [0 if harris_rank else 3] * 4
    assert calls[1][0] == (1, round(240 / 1.25), round(480 / 1.25))
    assert np.asarray(ref.mask).sum() > 100


def test_pyramid_rows_dispatch():
    """detect_keypoints routes ORB / BRISK with pyramid_levels > 1 to the
    pyramid detector, unbanded, as the JAX package does."""
    from matchinglib_poselib_tpu import config as jcfg
    from matchinglib_poselib_torch import config as tcfg

    img = _image("textured")
    for kind in ("ORB", "BRISK"):
        kw = dict(kind=kind, max_keypoints=128, fast_threshold=12.0,
                  pyramid_levels=3)
        kps = tfeat.detect_keypoints(t(img), tcfg.DetectorConfig(**kw))
        direct = ts.pyramid_fast_keypoints(t(img), 128, THR, n_levels=3,
                                           harris_rank=kind == "ORB")
        for a, b in zip(kps, direct):
            assert torch.equal(a, b)
        assert tfeat.detector_bands(tcfg.DetectorConfig(**kw)) == 0 == \
            jfeat.detector_bands(jcfg.DetectorConfig(**kw))


@pytest.fixture(scope="module")
def kaze_jax():
    """The JAX package's KAZE on both images: the scale space eagerly, as
    its own tests run it; the keypoints compiled, as ``detect_keypoints``
    runs them (one compile per file: both images are 240x480)."""
    kaze = jax.jit(jnd.kaze_keypoints, static_argnums=1)
    out = {}
    for name in ("textured", "scene"):
        img = jnp.asarray(_image(name))
        out[name] = (jnd._kcontrast(img), jnd.nonlinear_scale_space(img),
                     kaze(img, 256))
    return out


@pytest.mark.parametrize("image", ["textured", "scene"])
def test_kcontrast_and_levels_match_jax(kaze_jax, image):
    img = _image(image)
    kc, levels, _ = kaze_jax[image]
    np.testing.assert_allclose(float(tnd._kcontrast(t(img))), float(kc),
                               rtol=1e-6)
    mine = tnd.nonlinear_scale_space(t(img))
    exact = tnd.nonlinear_scale_space(torch.from_numpy(img).double())
    assert len(mine) == len(levels) == 7
    for (a, sa), (b, sb), (e, _) in zip(levels, mine, exact):
        assert sb == pytest.approx(float(sa), rel=1e-7)
        np.testing.assert_allclose(n(b), np.asarray(a), rtol=0, atol=1e-6)
        err_jax = np.abs(np.asarray(a, np.float64) - n(e)).max()
        err_port = np.abs(n(b).astype(np.float64) - n(e)).max()
        assert err_port <= 2 * err_jax + 1e-7, (err_port, err_jax)


@pytest.mark.parametrize("image,budget", [("textured", 0.99),
                                          ("scene", 0.96)])
def test_kaze_keypoints_match_jax(kaze_jax, image, budget):
    ref = kaze_jax[image][2]
    out = tnd.kaze_keypoints(t(_image(image)), 256)
    frac, flipped = _aligned(ref, out)
    assert frac >= budget, f"{flipped} keypoints differ ({frac:.4f})"
    assert np.asarray(ref.mask).sum() > 100
