"""Scale-space detectors (SIFT DoG, SURF Hessian): port vs JAX package.

Tolerances:
- ``gaussian_blur`` / ``_conv_sep``: atol 1e-6 on images in [0, 1]. The
  JAX package's XLA convolution and the port's tap loop sum the taps in
  other orders (and XLA contracts into FMAs), ~1 ulp apart.
- ``sift_dog_keypoints`` / ``surf_hessian_keypoints`` at 240x480 with 512
  slots: >= 99% of the keypoints valid on either side are found on the
  other at the same position (xy within 1e-4), with the same score
  within 1e-5 and the same scale. An extremum test on an f32 near tie
  (a neighbour within an ulp of the centre) can flip with that ulp: it
  adds or drops one keypoint, which shifts every later slot, or moves a
  pixel's extremum to another level. So keypoints are aligned by position
  before the comparison, and the assertion message reports how many
  flipped.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from matchinglib_poselib_tpu.ops import scale_space as js

from matchinglib_poselib_torch.ops import scale_space as ts

from chip_smoke import render_scene
from test_torch_helpers import (
    align_slots, aligned_fraction, n, t, textured_image,
)


def _image(name):
    if name == "scene":
        return render_scene(0, 480, 240)[0]
    return textured_image(np.random.default_rng(21), 240, 480)


@pytest.mark.parametrize("sigma", [1.2, 2.3, 8.5])
def test_gaussian_blur_matches_jax(sigma):
    img = _image("textured")
    ref = np.asarray(js.gaussian_blur(jnp.asarray(img), sigma))
    out = n(ts.gaussian_blur(t(img), sigma))
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(ts._gauss_kernel1d(sigma),
                                  js._gauss_kernel1d(sigma))


def test_conv_sep_box_and_edge_padding():
    """A non-Gaussian (box) kernel and a ramp image: edge-replicate padding
    and tap order as in the JAX package."""
    img = np.tile(np.linspace(0, 1, 64, dtype=np.float32), (40, 1))
    img[5:9, 50:60] = 1.0
    k = np.full((7,), 1.0 / 7.0, np.float32)
    ref = np.asarray(js._conv_sep(jnp.asarray(img), k))
    out = n(ts._conv_sep(t(img), k))
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    assert ts._n_octaves(240, 480) == js._n_octaves(240, 480) == 3
    assert ts._n_octaves(512, 1392) == js._n_octaves(512, 1392) == 4


@pytest.mark.parametrize("image", ["textured", "scene"])
@pytest.mark.parametrize("detector", ["sift_dog_keypoints",
                                      "surf_hessian_keypoints"])
def test_scale_space_keypoints_match_jax(detector, image):
    img = _image(image)
    ref = getattr(js, detector)(jnp.asarray(img), 512)
    out = getattr(ts, detector)(t(img), 512)
    assert out.xy.shape == (512, 2) and out.mask.shape == (512,)
    jm, tm = np.asarray(ref.mask), n(out.mask)
    perm = align_slots(ref.xy, jm, n(out.xy), tm)
    p = np.maximum(perm, 0)
    same = ((perm >= 0)
            & (np.abs(n(out.score)[p] - np.asarray(ref.score)) <= 1e-5)
            & (n(out.scale)[p] == np.asarray(ref.scale)))
    frac, flipped = aligned_fraction(np.where(same, perm, -1), jm, tm)
    assert frac >= 0.99, f"{flipped} keypoints differ"
    assert jm.sum() > 200
