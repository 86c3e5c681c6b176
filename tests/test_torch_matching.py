"""2-NN matching: port vs JAX package.

Binary (exact): the fused 2-NN kernel's plain version must equal the JAX
``knn2`` (Pallas kernel in interpret mode) on all three outputs for
xy_mode 0, 1 and 2, and ``match_descriptors`` must keep the same slots
with the same indices and distances as the JAX package (atol 0: Hamming
distances are integers). The set-ups follow tests/test_pallas_knn.py.

Float (squared L2): ``knn2_l2_plain`` against the Pallas general body in
interpret mode: |d_port - d_jax| <= 1e-5 (1 + |d_jax|) for d_best and
d_second (f32 dot products summed in another order); idx equal wherever
the JAX gap d_second - d_best exceeds 1e-5, and on every planted
duplicate candidate (lowest index); rows whose every candidate is gated
or invalid return exactly (1e9, 1e9, -1). ``match_descriptors(binary=
False)`` against the JAX ``use_pallas=True`` branch: masks >= 99.5% equal
(a ratio test on an f32 near tie may flip), idx equal wherever both keep.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from matchinglib_poselib_tpu.ops import matching as jm
from matchinglib_poselib_tpu.ops.pallas import knn as jknn

from matchinglib_poselib_torch.ops import matching as tm
from matchinglib_poselib_torch.ops.kernels import knn2 as tknn

from test_torch_helpers import n, t, words_u32_to_i32


def _words(rng, n_rows):
    return rng.integers(0, 2**32, (n_rows, 8), dtype=np.uint32)


def _guided_setup(rng, n1=120, n2=180):
    """Set 2 = noisy copies of set 1 + distractors, positions near the
    predictions, so real matches survive the ratio test inside the gate."""
    d1 = _words(rng, n1)
    flips = _words(rng, n1) & _words(rng, n1) & _words(rng, n1)
    d2 = np.concatenate([d1 ^ flips, _words(rng, n2 - n1)])
    p1 = rng.uniform(0, 200, (n1, 2)).astype(np.float32)
    pred = (p1 + rng.normal(scale=5.0, size=(n1, 2))).astype(np.float32)
    pts2 = np.concatenate([p1, rng.uniform(0, 200, (n2 - n1, 2))]).astype(
        np.float32)
    rad = rng.uniform(15, 60, (n1,)).astype(np.float32)
    return d1, d2, pred, pts2, rad


@pytest.mark.parametrize("xy_mode", [0, 1, 2])
def test_knn2_plain_equals_jax_knn2(xy_mode):
    rng = np.random.default_rng(10 + xy_mode)
    d1, d2, pred, pts2, rad = _guided_setup(rng, 120, 180)
    valid2 = rng.random(180) > 0.1
    # planted ties: duplicate candidates at two columns
    d2[150] = d2[3]
    d2[151] = d1[7]
    d2[152] = d1[7]
    if xy_mode == 2:
        rad2 = (rng.uniform(15, 60, (180,)) ** 2).astype(np.float32)
    else:
        rad2 = (rad * rad).astype(np.float32)
    args_j = [jm.bits_to_signs(jnp.asarray(d1)),
              jm.bits_to_signs(jnp.asarray(d2)), jnp.asarray(valid2)]
    if xy_mode:
        args_j += [jnp.asarray(pred), jnp.asarray(rad2), jnp.asarray(pts2)]
    ref = jknn.knn2(*args_j, binary=True, bits=256, xy_mode=xy_mode,
                    interpret=True)
    out = tknn.knn2(
        words_u32_to_i32(d1), words_u32_to_i32(d2), torch.from_numpy(valid2),
        *((t(pred), t(rad2), t(pts2)) if xy_mode else ()), xy_mode=xy_mode,
    )
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(n(o), np.asarray(r))
    assert out[2].dtype == torch.int32
    assert (n(out[2]) >= 0).sum() > 50


def _compare(ref, out):
    m = np.asarray(ref.mask)
    np.testing.assert_array_equal(n(out.mask), m)
    np.testing.assert_array_equal(n(out.idx)[m], np.asarray(ref.idx)[m])
    np.testing.assert_array_equal(n(out.distance)[m],
                                  np.asarray(ref.distance)[m])
    return m


@pytest.mark.parametrize("cross_check", [False, True])
def test_match_descriptors_unguided(cross_check):
    rng = np.random.default_rng(42)
    d1 = _words(rng, 150)
    flips = _words(rng, 150) & _words(rng, 150) & _words(rng, 150)
    d2 = np.concatenate([d1 ^ flips, _words(rng, 80)])
    v1 = rng.random(150) > 0.1
    v2 = rng.random(230) > 0.1
    kw = dict(binary=True, cross_check=cross_check)
    out = tm.match_descriptors(
        words_u32_to_i32(d1), words_u32_to_i32(d2), torch.from_numpy(v1),
        torch.from_numpy(v2), **kw)
    for use_pallas in (False, True):
        ref = jm.match_descriptors(
            jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(v1),
            jnp.asarray(v2), use_pallas=use_pallas, **kw)
        m = _compare(ref, out)
    assert m.sum() > 50


@pytest.mark.parametrize("cross_check", [False, True])
def test_match_descriptors_guided(cross_check):
    rng = np.random.default_rng(4)
    d1, d2, pred, pts2, rad = _guided_setup(rng)
    v1 = np.ones(120, bool)
    v2 = rng.random(180) > 0.05
    kw = dict(binary=True, cross_check=cross_check)
    ref = jm.match_descriptors(
        jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(v1), jnp.asarray(v2),
        guide_pred=jnp.asarray(pred), guide_rad=jnp.asarray(rad),
        pts2_xy=jnp.asarray(pts2), use_pallas=True, **kw)
    out = tm.match_descriptors(
        words_u32_to_i32(d1), words_u32_to_i32(d2), torch.from_numpy(v1),
        torch.from_numpy(v2), guide_pred=t(pred), guide_rad=t(rad),
        pts2_xy=t(pts2), **kw)
    m = _compare(ref, out)
    assert m.sum() > 20
    np.testing.assert_array_equal(n(out.second_distance),
                                  np.asarray(ref.second_distance))


def test_ratio_fallback_on_low_texture():
    """Fewer than 30 matches pass the ratio test (20 close copies; 80
    noisier copies with ratios just above 0.75; 100 random rows), so the
    best-ratio fallback decides the kept set — identically."""
    rng = np.random.default_rng(9)
    d1 = _words(rng, 200)
    p = np.where(np.arange(200) < 20, 0.25, 0.36)[:, None]
    flips = np.packbits(rng.random((200, 256)) < p, axis=1,
                        bitorder="little").view(np.uint32)
    d2 = d1 ^ flips
    d2[100:] = _words(rng, 100)
    v = np.ones(200, bool)
    ref = jm.match_descriptors(jnp.asarray(d1), jnp.asarray(d2),
                               jnp.asarray(v), jnp.asarray(v),
                               cross_check=False, use_pallas=False)
    out = tm.match_descriptors(words_u32_to_i32(d1), words_u32_to_i32(d2),
                               torch.from_numpy(v), torch.from_numpy(v),
                               cross_check=False)
    m = _compare(ref, out)
    assert 30 < m.sum() <= 60
    np.testing.assert_allclose(
        float(tm.estimate_inlier_ratio_from_ratios(out)),
        float(jm.estimate_inlier_ratio_from_ratios(ref)), rtol=0, atol=0)


def test_all_candidates_gated_or_invalid():
    """No valid candidate inside the gate: BIG distances, idx -1, no
    matches (the packed-kernel sentinel regression of the JAX tests)."""
    rng = np.random.default_rng(1)
    d1 = _words(rng, 16)
    d2 = np.tile(d1, (19, 1))[:300]
    valid2 = np.arange(300) % 2 == 0
    pred = np.full((16, 2), 1e6, np.float32)
    db, ds, idx = tknn.knn2(
        words_u32_to_i32(d1), words_u32_to_i32(d2), torch.from_numpy(valid2),
        t(pred), torch.ones(16), torch.zeros(300, 2), xy_mode=1)
    assert np.all(n(idx) == -1)
    assert np.all(n(db) == tknn.BIG) and np.all(n(ds) == tknn.BIG)
    out = tm.match_descriptors(
        words_u32_to_i32(d1), words_u32_to_i32(d2), torch.ones(16, dtype=bool),
        torch.zeros(300, dtype=bool), ratio_test=False, cross_check=False)
    assert int(out.n_matches) == 0


def test_hamming_matrix_and_top2_match_jax():
    rng = np.random.default_rng(6)
    d1, d2 = _words(rng, 40), _words(rng, 50)
    ref = np.asarray(jm.hamming_distance_matrix(jnp.asarray(d1),
                                                jnp.asarray(d2)))
    out = n(tm.hamming_distance_matrix(words_u32_to_i32(d1),
                                       words_u32_to_i32(d2)))
    np.testing.assert_array_equal(out, ref)
    ref2 = jm._top2(jnp.asarray(ref))
    out2 = tm._top2(torch.from_numpy(out))
    for o, r in zip(out2, ref2):
        np.testing.assert_array_equal(n(o), np.asarray(r))
    f1 = rng.normal(size=(30, 16)).astype(np.float32)
    f2 = rng.normal(size=(20, 16)).astype(np.float32)
    np.testing.assert_allclose(
        n(tm.l2_distance_matrix(t(f1), t(f2))),
        np.asarray(jm.l2_distance_matrix(jnp.asarray(f1), jnp.asarray(f2))),
        rtol=1e-5, atol=1e-4)
    assert tm.SUPPORTED_MATCHERS == jm.SUPPORTED_MATCHERS


def _unit_rows(rng, n_rows, d):
    x = rng.normal(size=(n_rows, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _float_setup(rng, d, n1=150, n2=230, n_gated=10):
    """Unit float descriptors (SIFT-like scale), set 2 = noisy copies of
    set 1 + distractors, ~10% invalid columns, two planted duplicate
    candidates per planted query (valid, on its predicted position), and
    `n_gated` trailing queries predicted far off."""
    d1 = _unit_rows(rng, n1, d)
    d2 = _unit_rows(rng, n2, d)
    d2[:n1 // 2] = d1[:n1 // 2] + 0.15 * _unit_rows(rng, n1 // 2, d)
    valid2 = rng.random(n2) > 0.1
    pred = rng.uniform(0, 200, (n1, 2)).astype(np.float32)
    pts2 = rng.uniform(0, 200, (n2, 2)).astype(np.float32)
    pts2[:n1 // 2] = pred[:n1 // 2] + rng.normal(scale=3, size=(n1 // 2, 2))
    planted = {7: (200, 211), 31: (203, 229)}
    for q, cols in planted.items():
        for c in cols:
            d2[c] = d1[q]
            valid2[c] = True
            pts2[c] = pred[q]
    pred[n1 - n_gated:] = 1e6
    return d1, d2, valid2, pred, pts2, planted


@pytest.mark.parametrize("depth", [128, 64, 67])
@pytest.mark.parametrize("xy_mode", [0, 1, 2])
def test_knn2_l2_plain_matches_jax_general_body(xy_mode, depth):
    rng = np.random.default_rng(100 * depth + xy_mode)
    d1, d2, valid2, pred, pts2, planted = _float_setup(rng, depth)
    n1, n2 = d1.shape[0], d2.shape[0]
    rad2 = (rng.uniform(15, 60, n1 if xy_mode == 1 else n2) ** 2).astype(
        np.float32)
    extra = (pred, rad2, pts2) if xy_mode else ()
    ref = [np.asarray(r) for r in jknn.knn2(
        *(jnp.asarray(a) for a in (d1, d2, valid2) + extra),
        binary=False, xy_mode=xy_mode, interpret=True)]
    out = [n(o) for o in tknn.knn2_l2(
        *(torch.from_numpy(a) for a in (d1, d2, valid2) + extra),
        xy_mode=xy_mode)]
    assert out[2].dtype == np.int32
    for o, r in zip(out[:2], ref[:2]):
        assert np.all(np.abs(o - r) <= 1e-5 * (1 + np.abs(r)))
    gap = ref[1] - ref[0] > 1e-5
    np.testing.assert_array_equal(out[2][gap], ref[2][gap])
    for q, cols in planted.items():
        assert out[2][q] == ref[2][q] == min(cols)
        assert out[1][q] == out[0][q]
    if xy_mode:
        for o, r, want in zip(out, ref, (1e9, 1e9, -1)):
            assert np.all(o[-10:] == want) and np.all(r[-10:] == want)
    assert (out[2] >= 0).sum() > 50


@pytest.mark.parametrize("cross_check", [False, True])
@pytest.mark.parametrize("guided", [False, True])
def test_match_descriptors_float(guided, cross_check):
    rng = np.random.default_rng(50 + 2 * guided + cross_check)
    d1, d2, valid2, pred, pts2, _ = _float_setup(rng, 128, n_gated=0)
    v1 = rng.random(d1.shape[0]) > 0.05
    rad = rng.uniform(15, 60, d1.shape[0]).astype(np.float32)
    guide = ((pred, rad, pts2) if guided else (None, None, None))
    kw = dict(binary=False, cross_check=cross_check)
    ref = jm.match_descriptors(
        jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(v1),
        jnp.asarray(valid2), use_pallas=True,
        guide_pred=None if not guided else jnp.asarray(pred),
        guide_rad=None if not guided else jnp.asarray(rad),
        pts2_xy=None if not guided else jnp.asarray(pts2), **kw)
    out = tm.match_descriptors(
        t(d1), t(d2), torch.from_numpy(v1), torch.from_numpy(valid2),
        guide_pred=None if not guided else t(guide[0]),
        guide_rad=None if not guided else t(guide[1]),
        pts2_xy=None if not guided else t(guide[2]), **kw)
    jmask, tmask = np.asarray(ref.mask), n(out.mask)
    assert (jmask == tmask).mean() >= 0.995
    both = jmask & tmask
    np.testing.assert_array_equal(n(out.idx)[both], np.asarray(ref.idx)[both])
    np.testing.assert_allclose(n(out.distance)[both],
                               np.asarray(ref.distance)[both], rtol=1e-5,
                               atol=1e-5)
    assert both.sum() > 30
