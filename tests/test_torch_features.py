"""FAST+NMS, keypoint selection, ORB, SIFT and M-SURF descriptors: port vs
JAX package.

Tolerances: FAST scores and NMS are exact (atol 0: same f32 operations in
the same order); keypoint score and mask exact slot for slot, xy within
1e-5 (subpixel offsets are f32 quotients); descriptors >= 99.5% of valid
slots bit-identical, and every slot that differs must sit within 1e-4 rad
of an ORB angle-bin edge (orientation moments are f32 sums taken in
another order, which can move a keypoint across a bin edge). Float
descriptors (SIFT, M-SURF) within atol 1e-5 on >= 99% of rows: a gradient
on an orientation- or cell-bin edge can move one pixel's vote to the
neighbouring bin, because atan2, sin and cos round differently in the two
packages (bins truncate toward zero in both, as ``astype(int32)``).
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from matchinglib_poselib_tpu import config as jcfg
from matchinglib_poselib_tpu.ops import features as jfeat
from matchinglib_poselib_tpu.ops.pallas import fast as pfast

from matchinglib_poselib_torch import config as tcfg
from matchinglib_poselib_torch.ops import features as tfeat
from matchinglib_poselib_torch.ops.kernels import fast_nms

from test_torch_helpers import n, t, textured_image, words_u32_to_i32

THR = 12.0 / 255.0


def _images():
    rng = np.random.default_rng(7)
    return {
        "random_96x200": rng.random((96, 200), np.float32),
        "textured_240x320": textured_image(rng, 240, 320),
    }


@pytest.mark.parametrize("name", ["random_96x200", "textured_240x320"])
def test_fast_score_and_nms_exact(name):
    img = _images()[name]
    ref_s = np.asarray(jfeat.fast_score(jnp.asarray(img), THR))
    out_s = n(tfeat.fast_score(t(img), THR))
    np.testing.assert_array_equal(out_s, ref_s)
    ref = np.asarray(jfeat.nms(jnp.asarray(ref_s), 3))
    out = n(tfeat.nms(t(ref_s), 3))
    np.testing.assert_array_equal(out, ref)
    assert (ref > 0).sum() > 20


# (image, radius, border): the interior case, then whole images
_PALLAS_FAST_CASES = {
    "random_96x200": ("random_96x200", 3, 16),
    "zero_border_37x53_r3": ((37, 53), 3, 0),
    "zero_border_70x129_r3": ((70, 129), 3, 0),
    "zero_border_96x200_r3": ("random_96x200", 3, 0),
    "zero_border_70x129_r0": ((70, 129), 0, 0),
    "zero_border_70x129_r5": ((70, 129), 5, 0),
}


@pytest.mark.parametrize("case", list(_PALLAS_FAST_CASES))
def test_plain_fast_nms_matches_pallas_interior(case):
    """The kernel's plain version vs the Pallas kernel (interpret mode),
    up to f32 ties inside an NMS window (the tie rule of
    tests/test_pallas_fast.py, over the (2r+1)^2 window). The interior
    case: equal at least 16 px from the border. The zero-border cases: at
    every pixel, border included, the plain version of the input
    zero-padded by 3 + r and cropped back: the semantics of the CUDA
    kernel, which reads pixels outside the image as 0 like the Pallas
    kernel's padding."""
    image, r, b = _PALLAS_FAST_CASES[case]
    img = (_images()[image] if isinstance(image, str)
           else np.random.default_rng(11).random(image, np.float32))
    p = 0 if b else 3 + r
    out = n(fast_nms.fast_nms_score_plain(
        torch.nn.functional.pad(t(img)[None], (p, p, p, p)), THR, r))[0]
    out = out[p:out.shape[0] - p, p:out.shape[1] - p]
    ref = np.asarray(pfast.fast_nms_score(jnp.asarray(img), THR, r,
                                          interpret=True))
    H, W = img.shape
    ri, oi = ref[b:H - b, b:W - b], out[b:H - b, b:W - b]
    yy, xx = np.where(ri != oi)
    for y, x in zip(yy + b, xx + b):
        v = max(ref[y, x], out[y, x])
        win = (slice(max(0, y - r), y + r + 1),
               slice(max(0, x - r), x + r + 1))
        assert np.min(np.abs(ref[win] - v)) < 1e-5
        assert np.min(np.abs(out[win] - v)) < 1e-5
    assert (oi > 0).sum() > 20


@pytest.mark.parametrize("bands", [8, 0])
def test_detect_keypoints_slot_for_slot(bands):
    img = textured_image(np.random.default_rng(3), 240, 320)
    kw = dict(kind="FAST", max_keypoints=256, fast_threshold=12.0,
              column_bands=bands)
    ref = jfeat.detect_keypoints(jnp.asarray(img), jcfg.DetectorConfig(**kw))
    out = tfeat.detect_keypoints(t(img), tcfg.DetectorConfig(**kw))
    np.testing.assert_array_equal(n(out.mask), np.asarray(ref.mask))
    np.testing.assert_array_equal(n(out.score), np.asarray(ref.score))
    np.testing.assert_allclose(n(out.xy), np.asarray(ref.xy), rtol=0,
                               atol=1e-5)
    assert int(out.n) > 50


def _bin_edge_distance(angle):
    """Distance (rad) of an angle to the nearest ORB bin rounding edge."""
    step = 2.0 * math.pi / tfeat.N_ANGLE_BINS
    a = np.mod(np.asarray(angle, np.float64), 2.0 * math.pi) / step
    return np.abs(a - np.floor(a) - 0.5) * step


def test_compute_descriptors_bit_identical():
    img = textured_image(np.random.default_rng(5), 240, 320)
    det = dict(kind="FAST", max_keypoints=256, fast_threshold=12.0,
               column_bands=8)
    jk = jfeat.detect_keypoints(jnp.asarray(img), jcfg.DetectorConfig(**det))
    jd, jk = jfeat.compute_descriptors(
        jnp.asarray(img), jk, jcfg.DescriptorConfig(), bands=8)
    tk = tfeat.detect_keypoints(t(img), tcfg.DetectorConfig(**det))
    td, tk = tfeat.compute_descriptors(t(img), tk, tcfg.DescriptorConfig(),
                                       bands=8)
    assert td.dtype == torch.int32 and td.shape == (256, 8)
    valid = np.asarray(jk.mask)
    same = np.all(n(td) == n(words_u32_to_i32(jd)), axis=1)
    assert same[valid].mean() >= 0.995
    np.testing.assert_allclose(n(tk.angle), np.asarray(jk.angle), atol=1e-4)
    differ = valid & ~same
    assert np.all(_bin_edge_distance(np.asarray(jk.angle)[differ]) < 1e-4)


def test_patches_and_orientation_match():
    """Banded and plain patch extraction sample the same bf16-rounded
    pixels as the JAX one-hot einsums (exact); intensity-centroid angles
    agree to 1e-5 rad."""
    rng = np.random.default_rng(11)
    img = textured_image(rng, 240, 320)
    xy = np.stack([rng.uniform(20, 300, 128), rng.uniform(20, 220, 128)],
                  axis=1).astype(np.float32)
    # banded contract: slot k's keypoint in column band k // (K / bands)
    gw = tfeat.band_width(320, 8)
    xy[:, 0] = (np.arange(128) // 16) * gw + rng.uniform(0, gw - 1, 128)
    xy[:, 0] = np.clip(xy[:, 0], 16, 303)
    for bands in (0, 8):
        ref = np.asarray(jfeat.extract_patches(jnp.asarray(img),
                                               jnp.asarray(xy), 31, bands))
        out = n(tfeat.extract_patches(t(img), t(xy), 31, bands))
        np.testing.assert_array_equal(out, ref)
    np.testing.assert_allclose(
        n(tfeat.orientation_ic(t(ref))),
        np.asarray(jfeat.orientation_ic(jnp.asarray(ref))), atol=1e-5)


def test_pack_bits_matches_uint32_words():
    rng = np.random.default_rng(2)
    bits = rng.integers(0, 2, (17, 256)).astype(bool)
    ref = np.asarray(jfeat._pack_bits(jnp.asarray(bits)))
    out = tfeat.pack_bits(torch.from_numpy(bits))
    np.testing.assert_array_equal(n(out), ref.view(np.int32))


def test_unported_detector_raises():
    """The rows this test once saw refused (HARRIS, STAR, DAISY) are
    ported: they run and give the JAX package's shapes; no row of either
    registry raises (tests/test_torch_frontend_menu.py walks them all)."""
    for kind in ("HARRIS", "STAR"):
        kps = tfeat.detect_keypoints(torch.zeros(64, 64),
                                     tcfg.DetectorConfig(kind=kind,
                                                         max_keypoints=32))
        assert kps.xy.shape == (32, 2) and not bool(kps.mask.any())
    desc, _ = tfeat.compute_descriptors(
        torch.zeros(64, 64),
        tfeat.Keypoints(*(torch.full((4, 2), 32.0),) + (torch.zeros(4),) * 3
                        + (torch.zeros(4, dtype=torch.bool),)),
        tcfg.DescriptorConfig(kind="DAISY"),
    )
    assert desc.shape == (4, 200) and desc.dtype == torch.float32


def _jax_patches(seed, k=200):
    """Patches and intensity-centroid angles of the JAX package at random
    positions of a textured image."""
    rng = np.random.default_rng(seed)
    img = textured_image(rng, 240, 320)
    xy = np.stack([rng.uniform(16, 304, k), rng.uniform(16, 224, k)],
                  axis=1).astype(np.float32)
    patches = jfeat.extract_patches(jnp.asarray(img), jnp.asarray(xy), 31)
    return patches, jfeat.orientation_ic(patches)


@pytest.mark.parametrize("kind,oriented", [
    ("sift", True), ("msurf", True), ("msurf", False)])
def test_float_descriptors_match_jax(kind, oriented):
    """Unoriented SIFT is left out: on this blocky texture most gradients
    are axis-aligned, XLA's atan2 rounds the exact quadrant angles one ulp
    apart from torch's, and (angle mod 2 pi) / 2 pi * 8 then lands on
    1.9999999 instead of 2.0, so whole rows vote in a neighbouring bin
    (ROADMAP C)."""
    from matchinglib_poselib_tpu.ops import nonlinear_diffusion as jnd
    from matchinglib_poselib_torch.ops import nonlinear_diffusion as tnd

    patches, angles = _jax_patches(13)
    jfn, tfn, dim = {
        "sift": (jfeat.sift_descriptor, tfeat.sift_descriptor, 128),
        "msurf": (jnd.msurf_descriptor, tnd.msurf_descriptor, 64),
    }[kind]
    ref = np.asarray(jfn(patches, angles, oriented))
    out = tfn(t(patches), t(angles), oriented)
    assert out.dtype == torch.float32 and out.shape == (200, dim)
    rows = np.abs(n(out) - ref).max(axis=1) <= 1e-5
    assert rows.mean() >= 0.99, f"{(~rows).sum()} rows off"
    np.testing.assert_allclose(np.linalg.norm(n(out), axis=1), 1.0,
                               atol=1e-5)


@pytest.mark.parametrize("det_kind,desc_kind,dim", [
    ("SIFT", "SIFT", 128), ("SURF", "SURF", 64), ("SIFT", "KAZE", 64)])
def test_float_detect_and_describe_dispatch(det_kind, desc_kind, dim):
    """detect_keypoints dispatches SIFT/SURF to scale_space (no bands) and
    compute_descriptors returns the JAX package's float descriptors for
    the same keypoints."""
    from matchinglib_poselib_torch.ops import scale_space as tss

    img = textured_image(np.random.default_rng(8), 160, 224)
    det = tcfg.DetectorConfig(kind=det_kind, max_keypoints=128)
    kps = tfeat.detect_keypoints(t(img), det)
    fn = (tss.sift_dog_keypoints if det_kind == "SIFT"
          else tss.surf_hessian_keypoints)
    direct = fn(t(img), 128)
    for a, b in zip(kps, direct):
        assert torch.equal(a, b)
    assert tfeat.detector_bands(det) == 0 == jfeat.detector_bands(
        jcfg.DetectorConfig(kind=det_kind, max_keypoints=128))
    jk = jfeat.detect_keypoints(jnp.asarray(img), jcfg.DetectorConfig(
        kind=det_kind, max_keypoints=128))
    jd, jk = jfeat.compute_descriptors(
        jnp.asarray(img), jk, jcfg.DescriptorConfig(kind=desc_kind))
    td, tk = tfeat.compute_descriptors(
        t(img), tfeat.Keypoints(*(t(x) for x in jk[:4]),
                                t(jk.mask, torch.bool)),
        tcfg.DescriptorConfig(kind=desc_kind))
    assert td.dtype == torch.float32 and td.shape == (128, dim)
    np.testing.assert_allclose(n(tk.angle), np.asarray(jk.angle), atol=1e-5)
    rows = np.abs(n(td) - np.asarray(jd)).max(axis=1) <= 1e-5
    assert rows[np.asarray(jk.mask)].mean() >= 0.99


def test_descriptor_registry_matches_jax():
    assert tfeat.DETECTOR_ALIASES == jfeat.DETECTOR_ALIASES
    assert tfeat.DESCRIPTOR_ALIASES == jfeat.DESCRIPTOR_ALIASES
    assert tfeat._BINARY_KINDS == jfeat._BINARY_KINDS
    for name in list(jfeat.DESCRIPTOR_ALIASES) + ["unknown"]:
        assert tfeat.is_binary_descriptor(name) == \
            jfeat.is_binary_descriptor(name)
        assert tfeat.is_bold_descriptor(name) == \
            jfeat.is_bold_descriptor(name)
