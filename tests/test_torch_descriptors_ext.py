"""The descriptor rows beyond ORB, SIFT and M-SURF, BOLD's matcher, and the
binary 2-NN at 2, 4 and 16 words: port vs JAX package.

Inputs: 300 patches and intensity-centroid angles extracted by the JAX
package at random positions of a textured 240x320 image (seeded), fed to
both packages; both orientations.

Tolerances:
- Tables (the ring patterns, LATCH triplets, BoostDesc rectangles, masks
  and projections, MLDB grid cells): equal.
- Binary descriptors (BRISK and FREAK rings, BOLD bits and stability
  masks, MLDB, LATCH, BGM, BINBOOST_64 / _128 / _256): every bit equal
  (measured 100%). BGM and BINBOOST are signs of mean-centred sums of
  bf16-rounded products: the port rounds both operands to bf16 and sums
  in fp32 in another order, so a response within an f32 rounding of 0
  could flip; none does here.
- Float descriptors: every row within `atol` of the JAX package's, and at
  least `share` of the rows within 1e-5 (measured values beside each
  case). RIFF with orientation: 2% of the rows differ by up to 4e-3,
  because a pixel whose rotated position lies on a sector edge goes to
  the neighbouring sector where atan2, sin or cos round apart (ROADMAP C);
  without orientation the sectors agree. LBGM and VGG with orientation:
  the bf16 rounding of a gradient map entry moves with an ulp of the
  rotated gradient, up to 6.4e-5 on < 1% of the rows.
- BOLD's distance matrix and ``match_bold``: exact (integer distances;
  ties to the lowest column, as ``lax.top_k`` and ``argmin``).
- ``knn2_plain`` at 2, 4 and 16 words: all three outputs equal to the JAX
  package's Pallas ``knn2`` (interpret mode) at ``bits = 32 W``, and
  ``match_descriptors`` equal to the JAX package's on mask, index and
  distance.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from matchinglib_poselib_tpu.ops import descriptors_ext as jde
from matchinglib_poselib_tpu.ops import descriptors_learned as jdl
from matchinglib_poselib_tpu.ops import features as jfeat
from matchinglib_poselib_tpu.ops import matching as jm
from matchinglib_poselib_tpu.ops import nonlinear_diffusion as jnd
from matchinglib_poselib_tpu.ops.pallas import knn as jknn

from matchinglib_poselib_torch.ops import descriptors_ext as tde
from matchinglib_poselib_torch.ops import descriptors_learned as tdl
from matchinglib_poselib_torch.ops import matching as tm
from matchinglib_poselib_torch.ops import nonlinear_diffusion as tnd
from matchinglib_poselib_torch.ops.kernels import knn2 as tknn

from test_torch_helpers import n, t, textured_image, words_u32_to_i32


@pytest.fixture(scope="module")
def patches():
    rng = np.random.default_rng(13)
    img = textured_image(rng, 240, 320)
    k = 300
    xy = np.stack([rng.uniform(16, 304, k), rng.uniform(16, 224, k)],
                  axis=1).astype(np.float32)
    p = jfeat.extract_patches(jnp.asarray(img), jnp.asarray(xy), 31)
    return p, jfeat.orientation_ic(p)


def test_tables_equal():
    for log in (False, True):
        for a, b in zip(tde.ring_pattern(log_spacing=log),
                        jde._ring_pattern(log_spacing=log)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tdl.latch_triplets(31),
                                  jdl._latch_triplets(31))
    for n_weak, seed in ((256, 21), (256, 23), (512, 31)):
        np.testing.assert_array_equal(tdl.boost_rects(n_weak, 31, seed),
                                      jdl._boost_rects(n_weak, 31, seed))
        np.testing.assert_array_equal(tdl.boost_masks(n_weak, 31, seed),
                                      jdl._boost_masks(n_weak, 31, seed))
    # the projections drawn inline by boostdesc_descriptor
    # (descriptors_learned.py:208-217)
    for d in (64, 128, 256):
        want = np.asarray(jnp.asarray(
            np.random.default_rng(29 + d).normal(size=(256, d)).astype(
                np.float32) / 16.0))
        np.testing.assert_array_equal(
            tdl.boost_projection(f"BINBOOST_{d}"), want)
    np.testing.assert_array_equal(
        tdl.boost_projection("LBGM"), np.asarray(jnp.asarray(
            np.random.default_rng(37).normal(size=(512, 64)).astype(
                np.float32))))
    for g in (2, 3, 4):
        np.testing.assert_array_equal(tnd._grid_cell_ids(31, g),
                                      jnd._grid_cell_ids(31, g))


def _binary_pair(kind, p, a, o):
    tp, ta = t(p), t(a)
    if kind == "ring":
        return (jde.ring_pattern_descriptor(p, a, o),
                tde.ring_pattern_descriptor(tp, ta, o))
    if kind == "ring_log":
        return (jde.ring_pattern_descriptor(p, a, o, log_spacing=True),
                tde.ring_pattern_descriptor(tp, ta, o, log_spacing=True))
    if kind == "bold":
        return (jnp.concatenate(jde.bold_descriptor(p, a, o), axis=1),
                torch.cat(tde.bold_descriptor(tp, ta, o), dim=1))
    if kind == "mldb":
        return jnd.mldb_descriptor(p, a, o), tnd.mldb_descriptor(tp, ta, o)
    if kind == "latch":
        return jdl.latch_descriptor(p, a, o), tdl.latch_descriptor(tp, ta, o)
    return (jdl.boostdesc_descriptor(p, a, kind, o),
            tdl.boostdesc_descriptor(tp, ta, kind, o))


@pytest.mark.parametrize("oriented", [True, False])
@pytest.mark.parametrize("kind,words", [
    ("ring", 16), ("ring_log", 16), ("bold", 32), ("mldb", 16),
    ("latch", 8), ("BGM", 8), ("BINBOOST_64", 2), ("BINBOOST_128", 4),
    ("BINBOOST_256", 8)])
def test_binary_descriptors_bit_equal(patches, kind, words, oriented):
    p, a = patches
    ref, out = _binary_pair(kind, p, a, oriented)
    assert out.dtype == torch.int32 and out.shape == (300, words)
    np.testing.assert_array_equal(n(out), np.asarray(ref, np.uint32).view(
        np.int32))
    bits = np.unpackbits(n(out).view(np.uint8))
    assert 0.2 < bits.mean() < 0.8


# (kind, oriented): (atol over all rows, share of rows within 1e-5), the
# measured max |port - JAX| in the comment
_FLOAT_CASES = {
    ("riff", True): (5e-3, 0.98),  # 4.0e-3, 98.0% of the rows
    ("riff", False): (1e-7, 1.0),  # 4.5e-8
    ("LBGM", True): (1e-4, 0.99),  # 6.4e-5, 99.3%
    ("LBGM", False): (5e-6, 1.0),  # 3.0e-6
    ("daisy", True): (5e-7, 1.0),  # 3.0e-7
    ("daisy", False): (5e-7, 1.0),  # 3.3e-7
    ("vgg", True): (5e-5, 0.99),  # 3.1e-5, 99.7%
    ("vgg", False): (3e-6, 1.0),  # 1.8e-6
}


@pytest.mark.parametrize("kind,oriented", list(_FLOAT_CASES))
def test_float_descriptors_match_jax(patches, kind, oriented):
    p, a = patches
    tp, ta = t(p), t(a)
    if kind == "riff":
        pairs = [(jde.riff_descriptor(p, a, oriented),
                  tde.riff_descriptor(tp, ta, oriented), 128)]
    elif kind == "LBGM":
        pairs = [(jdl.boostdesc_descriptor(p, a, "LBGM", oriented),
                  tdl.boostdesc_descriptor(tp, ta, "LBGM", oriented), 64)]
    elif kind == "daisy":
        pairs = [(jdl.daisy_descriptor(p, a, oriented),
                  tdl.daisy_descriptor(tp, ta, oriented), 200)]
    else:
        pairs = [(jdl.vgg_descriptor(p, a, d, oriented),
                  tdl.vgg_descriptor(tp, ta, d, oriented), d)
                 for d in (120, 80, 64, 48)]
    atol, share = _FLOAT_CASES[(kind, oriented)]
    for ref, out, dim in pairs:
        assert out.dtype == torch.float32 and out.shape == (300, dim)
        err = np.abs(n(out) - np.asarray(ref)).max(axis=1)
        assert err.max() <= atol, err.max()
        assert (err <= 1e-5).mean() >= share, (err <= 1e-5).mean()


def test_surf64_is_msurf(patches):
    p, a = patches
    np.testing.assert_array_equal(
        n(tdl.surf64_descriptor(t(p), t(a))),
        n(tnd.msurf_descriptor(t(p), t(a))))


def _bold_sets(patches, seed):
    p, a = patches
    bits, mask = jde.bold_descriptor(p, a, True)
    rng = np.random.default_rng(seed)
    v1 = rng.random(150) > 0.1
    v2 = rng.random(150) > 0.1
    return bits[:150], mask[:150], bits[150:], mask[150:], v1, v2


def test_bold_distance_matrix_exact(patches):
    b1, m1, b2, m2, _, _ = _bold_sets(patches, 0)
    ref = np.asarray(jde.bold_distance_matrix(b1, m1, b2, m2))
    out = tde.bold_distance_matrix(*(words_u32_to_i32(x)
                                     for x in (b1, m1, b2, m2)))
    np.testing.assert_array_equal(n(out), ref)
    assert (ref == np.round(ref)).all()


@pytest.mark.parametrize("ratio_test,cross_check", [
    (True, False), (True, True), (False, True)])
def test_match_bold_exact(patches, ratio_test, cross_check):
    b1, m1, b2, m2, v1, v2 = _bold_sets(patches, 1)
    # planted ties: two equal candidates and a candidate equal to a query
    b2 = np.asarray(b2).copy()
    m2 = np.asarray(m2).copy()
    b2[10], m2[10] = b2[3], m2[3]
    b2[20], m2[20] = np.asarray(b1)[5], np.asarray(m1)[5]
    kw = dict(ratio_test=ratio_test, ratio=0.75, cross_check=cross_check)
    ref = jde.match_bold(b1, m1, jnp.asarray(b2), jnp.asarray(m2),
                         jnp.asarray(v1), jnp.asarray(v2), **kw)
    out = tde.match_bold(*(words_u32_to_i32(x) for x in (b1, m1, b2, m2)),
                         torch.from_numpy(v1), torch.from_numpy(v2), **kw)
    for name in ("idx", "distance", "second_distance", "mask"):
        np.testing.assert_array_equal(n(getattr(out, name)),
                                      np.asarray(getattr(ref, name)), name)
    assert n(out.mask).sum() > 5


def _words(rng, rows, words):
    return rng.integers(0, 2**32, (rows, words), dtype=np.uint32)


@pytest.mark.parametrize("xy_mode", [0, 1, 2])
@pytest.mark.parametrize("words", [2, 4, 16])
def test_knn2_plain_other_widths_equal_jax(words, xy_mode):
    rng = np.random.default_rng(20 + words + xy_mode)
    n1, n2 = 90, 130
    d1 = _words(rng, n1, words)
    flips = _words(rng, n1, words) & _words(rng, n1, words)
    d2 = np.concatenate([d1[:60] ^ flips[:60], _words(rng, n2 - 60, words)])
    d2[100] = d2[4]  # duplicate candidate
    d2[101] = d2[102] = d1[7]  # two copies of a query
    d1[0] = 0  # all-zero row against an all-ones column: distance 32 W
    d2[110] = 2**32 - 1
    valid2 = rng.random(n2) > 0.1
    valid2[[4, 100, 101, 102, 110]] = True
    pred = rng.uniform(0, 100, (n1, 2)).astype(np.float32)
    pts2 = rng.uniform(0, 100, (n2, 2)).astype(np.float32)
    rad2 = (rng.uniform(30, 90, n1 if xy_mode == 1 else n2) ** 2).astype(
        np.float32)
    gate = (jnp.asarray(pred), jnp.asarray(rad2), jnp.asarray(pts2))
    ref = jknn.knn2(jm.bits_to_signs(jnp.asarray(d1)),
                    jm.bits_to_signs(jnp.asarray(d2)), jnp.asarray(valid2),
                    *(gate if xy_mode else ()), binary=True,
                    bits=32 * words, xy_mode=xy_mode, interpret=True)
    out = tknn.knn2_plain(words_u32_to_i32(d1), words_u32_to_i32(d2),
                          torch.from_numpy(valid2),
                          *((t(pred), t(rad2), t(pts2)) if xy_mode else ()),
                          xy_mode=xy_mode)
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(n(o), np.asarray(r))
    if xy_mode == 0:
        full = tknn.knn2_plain(words_u32_to_i32(d1[:1]),
                               words_u32_to_i32(d2[110:111]),
                               torch.ones(1, dtype=torch.bool))
        assert float(full[0][0]) == 32 * words


@pytest.mark.parametrize("words", [2, 4, 16])
def test_match_descriptors_other_widths(words):
    rng = np.random.default_rng(30 + words)
    d1 = _words(rng, 150, words)
    flips = (_words(rng, 150, words) & _words(rng, 150, words)
             & _words(rng, 150, words))
    d2 = np.concatenate([d1 ^ flips, _words(rng, 80, words)])
    v1 = rng.random(150) > 0.1
    v2 = rng.random(230) > 0.1
    out = tm.match_descriptors(
        words_u32_to_i32(d1), words_u32_to_i32(d2), torch.from_numpy(v1),
        torch.from_numpy(v2), binary=True, cross_check=False)
    for use_pallas in (False, True):
        ref = jm.match_descriptors(
            jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(v1),
            jnp.asarray(v2), binary=True, cross_check=False,
            use_pallas=use_pallas)
        m = np.asarray(ref.mask)
        np.testing.assert_array_equal(n(out.mask), m)
        np.testing.assert_array_equal(n(out.idx)[m], np.asarray(ref.idx)[m])
        np.testing.assert_array_equal(n(out.distance)[m],
                                      np.asarray(ref.distance)[m])
    assert m.sum() > 20
