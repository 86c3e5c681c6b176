"""The three kernels' plain versions and wrappers over the JAX package's
whole input domain: port vs JAX package on the CPU.

- K1 at a threshold below 0 (the CUDA kernel's second instantiation keeps
  the bright and the dark relu arguments apart, as the Pallas body does):
  ``fast_nms_score_plain`` against the JAX package's XLA path
  (``features.nms(features.fast_score(.))``, exact at every pixel) and its
  Pallas kernel in interpret mode (which samples I(p + o) where XLA
  samples I(p - o): exact up to f32 ties inside an NMS window, at every
  pixel of the input zero-padded by 3 + r); ``get_correspondences`` at
  ``fast_threshold = -1`` against the JAX package's, keypoints aligned by
  position.
- K2a past one launch's columns: ``merge_top2`` of ``knn2_plain`` over
  column chunks equals ``knn2_plain`` over the whole set, bit for bit
  (the rule the wrapper merges its chunked launches by); ``match_descriptors``
  at 24 and 32 words against the JAX package's, every field of every row.
- K2b past D = 640: ``match_descriptors`` at D = 768 against the JAX
  package's: distances within 1e-5 (1 + |d|), idx and mask equal where no
  near tie decides them.
- ``StageTimer.row()`` / ``total_ms()`` / ``STAGES`` as the JAX package's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from matchinglib_poselib_tpu import config as jcfg
from matchinglib_poselib_tpu.models import pipeline as jpipe
from matchinglib_poselib_tpu.ops import features as jfeat
from matchinglib_poselib_tpu.ops import matching as jm
from matchinglib_poselib_tpu.ops.pallas import fast as pfast
from matchinglib_poselib_tpu.utils import profiling as jprof

from matchinglib_poselib_torch import config as tcfg
from matchinglib_poselib_torch.models import pipeline as tpipe
from matchinglib_poselib_torch.ops import features as tfeat
from matchinglib_poselib_torch.ops import matching as tm
from matchinglib_poselib_torch.ops.kernels import fast_nms
from matchinglib_poselib_torch.ops.kernels import knn2 as tknn
from matchinglib_poselib_torch.utils import profiling as tprof

import chip_smoke
from test_torch_helpers import n, t, textured_image, words_u32_to_i32

NEG_THRESHOLDS = (-4.0 / 255.0, -12.0 / 255.0)


def _textured():
    return textured_image(np.random.default_rng(17), 96, 200)


@pytest.mark.parametrize("radius", [0, 3, 5])
@pytest.mark.parametrize("thr", NEG_THRESHOLDS)
def test_fast_below_zero_equals_jax_xla(thr, radius):
    """The plain version equals the JAX package's XLA path at every pixel
    (the same f32 operations in the same order; both wrap at the border),
    flat blocks included, where every pixel scores 16 |t| and the NMS
    keeps its ties."""
    img = _textured()
    ref = np.asarray(jfeat.nms(jfeat.fast_score(jnp.asarray(img), thr),
                               radius))
    out = n(fast_nms.fast_nms_score_plain(t(img)[None], thr, radius))[0]
    np.testing.assert_array_equal(out, ref)
    score = n(tfeat.fast_score(t(img), thr))
    assert (score > 0).mean() > 0.5  # t < 0: most pixels are corners
    assert (out > 0).sum() > 20


@pytest.mark.parametrize("radius", [0, 3, 5])
@pytest.mark.parametrize("thr", NEG_THRESHOLDS)
def test_fast_below_zero_matches_pallas(thr, radius):
    """The plain version of the input zero-padded by 3 + r (the CUDA
    kernel's semantics) against the Pallas kernel in interpret mode at
    every pixel: equal but where an NMS decision differs on a window that
    holds the same score within 1e-5 on both sides (the Pallas body sums
    its ring in the order of I(p + o))."""
    img = _textured()
    p = 3 + radius
    out = n(fast_nms.fast_nms_score_plain(
        torch.nn.functional.pad(t(img)[None], (p, p, p, p)), thr,
        radius))[0, p:-p, p:-p]
    ref = np.asarray(pfast.fast_nms_score(jnp.asarray(img), thr, radius,
                                          interpret=True))
    for y, x in zip(*np.where(out != ref)):
        v = max(ref[y, x], out[y, x])
        win = (slice(max(0, y - radius), y + radius + 1),
               slice(max(0, x - radius), x + radius + 1))
        assert np.min(np.abs(ref[win] - v)) < 1e-5
        assert np.min(np.abs(out[win] - v)) < 1e-5
    assert (out > 0).sum() > 20


def test_get_correspondences_below_zero_matches_jax():
    img1, img2, _, _, _ = chip_smoke.render_scene(0, 480, 240)
    kw = dict(kind="FAST", max_keypoints=512, fast_threshold=-1.0)
    jr = jpipe.get_correspondences(
        jnp.asarray(img1), jnp.asarray(img2), jcfg.DetectorConfig(**kw),
        jcfg.DescriptorConfig(kind="ORB"), jcfg.MatchingConfig())
    tr = tpipe.get_correspondences(
        t(img1), t(img2), tcfg.DetectorConfig(**kw),
        tcfg.DescriptorConfig(kind="ORB"), tcfg.MatchingConfig())
    as_port = tpipe.Correspondences(
        *(t(x) for x in jr[:5]),
        *(tfeat.Keypoints(*(t(x) for x in k)) for k in (jr.kps1, jr.kps2)))
    agree = chip_smoke.aligned_agreement(as_port, tr)
    assert agree["keypoints"] == 1.0, agree
    assert agree["matches"] == 1.0, agree
    assert int(np.asarray(jr.mask).sum()) > 50


def _chunk_case(rng, n1, n2, words, xy_mode, bounds):
    """Random words with ~10% invalid columns; every column of the chunk
    [bounds[0], bounds[1]) invalid; copies of query 0 on both sides of the
    first chunk boundary, of query 1 on both sides of the second, a copy
    of candidate 3 at the last column; the last rows outside every gate
    (xy_mode 1 and 2)."""
    d1 = rng.integers(-2**31, 2**31, (n1, words)).astype(np.int32)
    d2 = rng.integers(-2**31, 2**31, (n2, words)).astype(np.int32)
    valid2 = rng.random(n2) > 0.1
    valid2[bounds[0]:bounds[1]] = False
    pred = rng.uniform(0, 100, (n1, 2)).astype(np.float32)
    pts2 = rng.uniform(0, 100, (n2, 2)).astype(np.float32)
    for q, b in ((0, bounds[0]), (1, bounds[1])):
        d2[b - 1:b + 1] = d1[q]
        valid2[b - 1:b + 1] = True
        pts2[b - 1:b + 1] = pred[q]
    d2[n2 - 1] = d2[3]
    pred[n1 - 8:] = 1e6
    rad2 = (rng.uniform(20, 80, n1 if xy_mode == 1 else n2) ** 2).astype(
        np.float32)
    args = (d1, d2, valid2) + ((pred, rad2, pts2) if xy_mode else ())
    return tuple(torch.from_numpy(a) for a in args)


@pytest.mark.parametrize("chunk", [64, 100, 257])
@pytest.mark.parametrize("xy_mode", [0, 1, 2])
def test_merge_top2_of_chunks_equals_whole(xy_mode, chunk):
    """``knn2_plain`` chunk by chunk of `chunk` columns, columns made
    global and merged by ``merge_top2``, equals ``knn2_plain`` over every
    column on all three outputs: ties across chunk boundaries go to the
    lower column, a chunk of invalid columns adds nothing, rows gated out
    everywhere stay (1e9, 1e9, -1)."""
    rng = np.random.default_rng(20 + xy_mode)
    n1, n2 = 40, 700
    args = _chunk_case(rng, n1, n2, 8, xy_mode, (chunk, 2 * chunk))
    d1, d2, valid2 = args[:3]
    pred, rad2, pts2 = args[3:] if xy_mode else (None, None, None)
    want = tknn.knn2_plain(*args, xy_mode=xy_mode)
    outs = []
    for c0 in range(0, n2, chunk):
        sl = slice(c0, c0 + chunk)
        b, s, i = tknn.knn2_plain(
            d1, d2[sl], valid2[sl], pred,
            rad2[sl] if xy_mode == 2 else rad2,
            pts2[sl] if xy_mode else None, xy_mode)
        outs.append((b, s, torch.where(i >= 0, i + c0, -1)))
    got = tknn.merge_top2(*(torch.stack(x) for x in zip(*outs)))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        assert torch.equal(g, w)
    for q, b in ((0, chunk), (1, 2 * chunk)):
        assert (int(got[2][q]), float(got[0][q]), float(got[1][q])) == (
            b - 1, 0.0, 0.0)
    if xy_mode:
        assert torch.all(got[0][n1 - 8:] == 1e9)
        assert torch.all(got[2][n1 - 8:] == -1)


def test_kernel_widths_and_columns():
    """The wrapper's padded width and one launch's column count: 8 and 16
    words keep their instantiations (2^24 and 2^23 columns a launch, 21
    and 20 bits of key column); a wider descriptor pads to a multiple of
    8 words, with a distance field of bit_length(64 W) bits."""
    assert [tknn.kernel_words(w) for w in (1, 7, 8, 9, 16, 17, 24, 25, 64)] \
        == [8, 8, 8, 16, 16, 24, 24, 32, 64]
    assert tknn.max_columns(8) == 1 << 24
    assert tknn.max_columns(16) == 1 << 23
    assert [tknn.key_column_bits(w) for w in (8, 16, 24, 32, 64)] == [
        21, 20, 20, 19, 18]
    with pytest.raises(ValueError):
        tknn.kernel_words(0)
    with pytest.raises(ValueError):
        tknn.kernel_words(tknn.MAX_WORDS + 1)


def _wide_words(rng, n_rows, words):
    return rng.integers(0, 2**32, (n_rows, words), dtype=np.uint32)


@pytest.mark.parametrize("cross_check", [False, True])
@pytest.mark.parametrize("words", [24, 32])
def test_match_descriptors_wide_equals_jax(words, cross_check):
    """Descriptors of 24 and 32 words (the CUDA kernel's runtime width):
    every field of every row equal to the JAX package's Pallas path
    (interpret mode), and of every valid query's row to its XLA path
    (which scores an invalid query's row as all 1e9, index 0; the port
    follows the Pallas path, ROADMAP §C)."""
    rng = np.random.default_rng(30 + words)
    d1 = _wide_words(rng, 120, words)
    flips = (_wide_words(rng, 120, words) & _wide_words(rng, 120, words)
             & _wide_words(rng, 120, words))
    d2 = np.concatenate([d1 ^ flips, _wide_words(rng, 60, words)])
    d2[150] = d2[7]  # a tie between two candidates
    v1 = rng.random(120) > 0.05
    v2 = rng.random(180) > 0.1
    kw = dict(binary=True, cross_check=cross_check)
    out = tm.match_descriptors(
        words_u32_to_i32(d1), words_u32_to_i32(d2), torch.from_numpy(v1),
        torch.from_numpy(v2), **kw)
    for use_pallas in (False, True):
        ref = jm.match_descriptors(
            jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(v1),
            jnp.asarray(v2), use_pallas=use_pallas, **kw)
        rows = slice(None) if use_pallas else v1
        for f in ("idx", "distance", "second_distance", "mask"):
            np.testing.assert_array_equal(n(getattr(out, f))[rows],
                                          np.asarray(getattr(ref, f))[rows],
                                          f)
    assert n(out.mask).sum() > 50


@pytest.mark.parametrize("guided", [False, True])
def test_match_descriptors_float_768_equals_jax(guided):
    """Float descriptors at D = 768 (past the depth the CUDA kernel keeps
    whole in shared memory) against the JAX package's Pallas general body
    (interpret mode): distances within 1e-5 (1 + |d|) on every row, idx
    and mask equal on every row whose decision no near tie makes."""
    rng = np.random.default_rng(40 + guided)
    depth, n1, n2 = 768, 100, 150
    d1 = rng.normal(size=(n1, depth)).astype(np.float32)
    d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
    d2 = np.concatenate([d1 + 0.02 * rng.normal(size=(n1, depth)),
                         rng.normal(size=(n2 - n1, depth))]).astype(
        np.float32)
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    v1 = rng.random(n1) > 0.05
    v2 = rng.random(n2) > 0.1
    pred = rng.uniform(0, 200, (n1, 2)).astype(np.float32)
    pts2 = np.concatenate([pred[:n1] + rng.normal(scale=3, size=(n1, 2)),
                           rng.uniform(0, 200, (n2 - n1, 2))]).astype(
        np.float32)
    rad = rng.uniform(15, 60, n1).astype(np.float32)
    g = (pred, rad, pts2) if guided else (None,) * 3
    kw = dict(binary=False, cross_check=True)
    ref = jm.match_descriptors(
        jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(v1), jnp.asarray(v2),
        use_pallas=True, guide_pred=None if not guided else jnp.asarray(g[0]),
        guide_rad=None if not guided else jnp.asarray(g[1]),
        pts2_xy=None if not guided else jnp.asarray(g[2]), **kw)
    out = tm.match_descriptors(
        t(d1), t(d2), torch.from_numpy(v1), torch.from_numpy(v2),
        guide_pred=None if not guided else t(g[0]),
        guide_rad=None if not guided else t(g[1]),
        pts2_xy=None if not guided else t(g[2]), **kw)
    rd, rs = np.asarray(ref.distance), np.asarray(ref.second_distance)
    tol = 1e-5 * (1 + np.abs(rd))
    assert np.all(np.abs(n(out.distance) - rd) <= tol)
    assert np.all(np.abs(n(out.second_distance) - rs)
                  <= 1e-5 * (1 + np.abs(rs)))
    clear = (rs - rd > tol) & (np.abs(rd - 0.75 * rs) > tol)
    np.testing.assert_array_equal(n(out.idx)[clear],
                                  np.asarray(ref.idx)[clear])
    np.testing.assert_array_equal(n(out.mask)[clear],
                                  np.asarray(ref.mask)[clear])
    assert n(out.mask).sum() > 30


def test_stage_timer_row_and_total_equal_jax():
    """The same stage times give the same CSV row and total; reset clears
    the times and the stage order."""
    assert tprof.STAGES == jprof.STAGES
    timers = (tprof.StageTimer(), jprof.StageTimer())
    for timer in timers:
        for name in ("matching", "keypoints", "matching"):
            with timer.stage(name):
                pass
        timer.times_ms.update(keypoints=1.23456, matching=7.5,
                              stereoRefine=0.0004)
    (tt, jt) = timers
    assert tt.row() == jt.row()
    assert list(tt.row()) == [f"{s}_ms" for s in jprof.STAGES]
    assert tt.total_ms() == jt.total_ms()
    assert tt._order == jt._order == ["matching", "keypoints"]
    for timer in timers:
        timer.reset()
    assert tt.row() == jt.row() and tt.total_ms() == jt.total_ms() == 0.0
    assert tt._order == jt._order == []
