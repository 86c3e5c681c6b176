"""Port parity: ``ops/rectify.py``, ``geometry.cam_to_img`` and
``geometry.angles_from_rot`` against the JAX package.

Rigs: seeded general rigs (K1 != K2, a few degrees of rotation, Oulu
distortion) and the KITTI-like rig of ``chip_smoke.render_scene`` at
120x160. Tolerances: every rectification field, the chosen focal scale and
the vergence equal to the bit (the port sums the rig's 3x3 products and
inverts K as XLA's CPU code does: ``rectify._mm``, ``_inv3``);
``rectified_image`` within 1e-5 max abs on the rendered scene's images
from the same rectification (XLA sums each pixel's ray in an order of its
own, so the sample coordinates differ by a few f32 ulps).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from matchinglib_poselib_tpu.ops import geometry as jgeo
from matchinglib_poselib_tpu.ops import rectify as jrect
from matchinglib_poselib_torch.ops import geometry as tgeo
from matchinglib_poselib_torch.ops import rectify as trect

from chip_smoke import render_scene
from conftest import random_pose
from test_torch_helpers import j, n, t

HW = (120, 160)
IMAGE_ATOL = 1e-5


def _general_rig(seed):
    """K1 != K2, up to 6 deg of rotation, a mostly horizontal baseline and
    Oulu distortion (as tests/test_rectify.py's rig, scaled to HW)."""
    rng = np.random.default_rng(seed)
    K1 = np.array([[155.0, 0, 82.5], [0, 153.75, 61.25], [0, 0, 1.0]])
    K2 = np.array([[151.25, 0, 78.75], [0, 150.0, 58.75], [0, 0, 1.0]])
    R, _ = random_pose(rng, max_angle_deg=6.0)
    tt = np.array([-0.54, 0.01, 0.005]) + rng.normal(scale=0.003, size=3)
    d = np.array([-0.1, 0.05, 0.001, -0.001, 0.01]) * rng.uniform(0, 1)
    return K1, K2, R, tt, d, d * 0.5


def _kitti_rig():
    """chip_smoke.render_scene's rig at HW (no distortion)."""
    _, _, K, R, tt = render_scene(0, HW[1], HW[0])
    return K, K, R, tt, np.zeros(5), np.zeros(5)


RIGS = {f"seed{s}": (lambda s=s: _general_rig(s)) for s in range(4)}
RIGS["kitti"] = _kitti_rig


def _check_rect(jr, tr):
    for f in jr._fields:
        want, got = np.asarray(getattr(jr, f)), n(getattr(tr, f))
        assert got.dtype == want.dtype and np.array_equal(got, want), f


@pytest.mark.parametrize("rig", sorted(RIGS))
def test_rectification_matches_jax(rig):
    K1, K2, R, tt, d1, d2 = RIGS[rig]()
    ja = [j(x) for x in (K1, K2, R, tt)]
    ta = [t(x) for x in (K1, K2, R, tt)]
    _check_rect(jrect.rectify_fusiello(*ja), trect.rectify_fusiello(*ta))
    for zero_disp in (True, False):
        _check_rect(
            jrect.stereo_rectify(*ja, HW, 1.1, zero_disparity=zero_disp),
            trect.stereo_rectify(*ta, HW, 1.1, zero_disparity=zero_disp))
    js = jrect.optimal_focal_scale(*ja, j(d1), j(d2), HW)
    ts = trect.optimal_focal_scale(*ta, t(d1), t(d2), HW)
    assert float(js) == float(ts)
    for fus in (False, True):
        jr = jrect.get_rectification_parameters(*ja, j(d1), j(d2), HW,
                                                use_fusiello=fus)
        tr = trect.get_rectification_parameters(*ta, t(d1), t(d2), HW,
                                                use_fusiello=fus)
        _check_rect(jr, tr)
        _check_vergence(ja[2], jr, tr)
    # a rig with per-camera cx has a vergence of pixels (a shared-cx rig's
    # is ~1e-7 px, 0 or 1 after ceil(1.1 v) on the last bits)
    jr = jrect.stereo_rectify(*ja, HW, 1.0, zero_disparity=False)
    tr = trect.stereo_rectify(*ta, HW, 1.0, zero_disparity=False)
    assert _check_vergence(ja[2], jr, tr) != 0


def _check_vergence(R, jr, tr):
    jv = int(jrect.estimate_vergence(R, jr.R1, jr.R2, jr.P1, jr.P2))
    tv = int(trect.estimate_vergence(t(R), tr.R1, tr.R2, tr.P1, tr.P2))
    assert jv == tv
    return tv


@pytest.mark.parametrize("rig", sorted(RIGS))
def test_rectified_image_matches_jax(rig):
    K1, K2, R, tt, d1, d2 = RIGS[rig]()
    img1, img2, _, _, _ = render_scene(1, HW[1], HW[0])
    jr = jrect.get_rectification_parameters(
        j(K1), j(K2), j(R), j(tt), j(d1), j(d2), HW)
    for img, K, d, Rr, Kn in ((img1, K1, d1, jr.R1, jr.K_new1),
                              (img2, K2, d2, jr.R2, jr.K_new2)):
        want = jrect.rectified_image(j(img), j(K), j(d), Rr, Kn, HW)
        got = trect.rectified_image(t(img), t(K), t(d), t(Rr), t(Kn), HW)
        assert got.shape == HW and got.dtype == torch.float32
        err = float(np.abs(n(want) - n(got)).max())
        assert err <= IMAGE_ATOL, err
        # the remap is not trivial: most of the frame is filled
        assert float((n(got) > 0).mean()) > 0.8


def test_rectify_source_coords_matches_jax():
    K1, K2, R, tt, d1, _ = _general_rig(7)
    rng = np.random.default_rng(7)
    px = rng.uniform([-10, -10], [HW[1] + 10, HW[0] + 10], (500, 2))
    jr = jrect.stereo_rectify(j(K1), j(K2), j(R), j(tt), HW, 1.0)
    want = jrect.rectify_source_coords(j(px), j(K1), j(d1), jr.R1,
                                       jr.K_new1)
    got = trect.rectify_source_coords(t(px), t(K1), t(d1), t(jr.R1),
                                      t(jr.K_new1))
    # pixel coordinates up to ~170: 1e-4 px is a few f32 ulps
    np.testing.assert_allclose(n(got), np.asarray(want), rtol=0, atol=1e-4)


def test_cam_to_img_and_angles_from_rot_match_jax():
    rng = np.random.default_rng(3)
    K = np.array([[612.5, 0.3, 331.0], [0, 608.0, 242.5], [0, 0, 1.0]])
    x = rng.normal(scale=0.4, size=(6, 50, 2))
    np.testing.assert_allclose(n(tgeo.cam_to_img(t(x), t(K))),
                               np.asarray(jgeo.cam_to_img(j(x), j(K))),
                               rtol=1e-6, atol=1e-4)
    Rs = np.stack([random_pose(rng, 40.0)[0] for _ in range(64)])
    want = np.asarray(jgeo.angles_from_rot(j(Rs)))
    got = n(tgeo.angles_from_rot(t(Rs)))
    assert got.shape == (64, 3)
    # degrees: atan2 / asin of f32 entries, equal up to an ulp or two
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert float(np.abs(want).max()) > 5.0


def test_small_products_and_inverse_match_jax():
    """The back substitution that maps pixels to rays equals XLA's
    ``jnp.linalg.inv`` bit for bit on upper-triangular K (the camera
    matrices), a general K takes the LU route; ``_mm`` equals XLA's 3x3
    and 3x4 products bit for bit."""
    rng = np.random.default_rng(11)
    Ks = np.zeros((200, 3, 3), np.float32)
    Ks[:, 0, 0], Ks[:, 1, 1] = rng.uniform(100, 1500, (2, 200))
    Ks[:, 0, 2], Ks[:, 1, 2] = rng.uniform(50, 800, (2, 200))
    Ks[::2, 0, 1] = rng.uniform(-1, 1, 100)
    Ks[:, 2, 2] = 1.0
    want = np.stack([np.asarray(jnp.linalg.inv(j(K))) for K in Ks])
    assert np.array_equal(n(trect._inv3(t(Ks))), want)
    G = rng.normal(size=(3, 3)) + 3 * np.eye(3)
    np.testing.assert_allclose(n(trect._inv3(t(G))), np.linalg.inv(G),
                               rtol=1e-5, atol=1e-6)
    A = rng.normal(size=(50, 3, 3)).astype(np.float32)
    B = rng.normal(size=(50, 3, 4)).astype(np.float32)
    want = np.stack([np.asarray(jax.jit(jnp.matmul)(a, b))
                     for a, b in zip(A, B)])
    assert np.array_equal(n(trect._mm(t(A), t(B))), want)
