"""The whole front-end menu through the pipeline: port vs JAX package.

- ``get_correspondences`` at 240x480 with 512 slots on the synthetic scene
  (``chip_smoke.render_scene``) against the JAX package's, on
  combinations that together cover every detector and descriptor family
  added beside FAST/ORB, SIFT and SURF (the KAZE rows are in
  tests/test_torch_frontend_kaze.py). Keypoints are aligned by position
  (``chip_smoke.aligned_agreement``, as phase 9 compares the card with
  the CPU): >= 99% of the keypoints valid on either side found on
  the other (measured 100%, MSER 99.6%: one DoG extremum on an f32 near
  tie). Matches are compared on the aligned query slots: the match mask
  equal and, where both keep a match, the partner within 1e-4 px, on >=
  99% of them (measured 100%; MSD/RIFF 99.8%: RIFF's sector flips move
  one ratio test). MSER/DAISY: >= 87% (measured 87.7%, 186 matches
  against 176): the one flipped DoG extremum moves GMBSOF's guided
  rematch (with AUTOTH off too; with the FLANN matcher, no guided pass,
  the slots agree 100%).
- Every name of ``DETECTOR_ALIASES`` (and ORB, BRISK with
  pyramid_levels > 1) and of ``DESCRIPTOR_ALIASES`` runs through
  ``get_correspondences`` and ``StereoPipeline.run_batch`` on the CPU with
  the output shapes and widths of its row; none raises.
- ``run_batch`` on 2 pairs equals ``run`` on each pair on the CPU (slots,
  inlier masks, pose within ``assert_pose_equal``'s 1e-5) for FAST/BOLD
  and HARRIS/LATCH.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from matchinglib_poselib_tpu import config as jcfg
from matchinglib_poselib_tpu.models import pipeline as jpipe

from matchinglib_poselib_torch import config as tcfg
from matchinglib_poselib_torch.models import pipeline as tpipe
from matchinglib_poselib_torch.ops import features as tfeat

import chip_smoke
from test_torch_helpers import assert_pair_equal, t

# (detector, descriptor, pyramid levels, share of aligned match slots)
_COMBOS = [
    ("HARRIS", "LATCH", 1, 0.99),
    ("GFTT", "BGM", 1, 0.99),
    ("STAR", "BRISK", 1, 0.99),
    ("MSD", "RIFF", 1, 0.99),
    ("MSER", "DAISY", 1, 0.87),
    ("ORB", "VGG_64", 3, 0.99),
    ("BRISK", "BINBOOST_64", 3, 0.99),
    ("FAST", "BOLD", 1, 0.99),
    ("FAST", "FREAK", 1, 0.99),
    ("FAST", "LBGM", 1, 0.99),
    ("GFTT", "BINBOOST_128", 1, 0.99),
]


def _scene():
    return chip_smoke.render_scene(0, 480, 240)


def compare_aligned(jr, tr, kp_share=0.99, match_share=0.99,
                    min_matches=100):
    """The JAX package's correspondences against the port's with
    keypoints aligned by position (``chip_smoke.aligned_agreement``):
    >= kp_share of the keypoints, >= match_share of the aligned match
    slots, more than `min_matches` matches."""
    def kps(k):
        return tfeat.Keypoints(*(t(x) for x in k))

    as_port = tpipe.Correspondences(
        *(t(x) for x in jr[:5]), kps(jr.kps1), kps(jr.kps2))
    agree = chip_smoke.aligned_agreement(as_port, tr)
    assert agree["keypoints"] >= kp_share, agree
    assert agree["matches"] >= match_share, agree
    assert int(np.asarray(jr.mask).sum()) > min_matches
    return agree


@pytest.mark.parametrize("det,desc,levels,share", _COMBOS,
                         ids=[f"{d}-{e}" for d, e, _, _ in _COMBOS])
def test_get_correspondences_matches_jax(det, desc, levels, share):
    img1, img2, _, _, _ = _scene()
    kw = dict(kind=det, max_keypoints=512, fast_threshold=12.0,
              pyramid_levels=levels)
    jr = jpipe.get_correspondences(
        jnp.asarray(img1), jnp.asarray(img2), jcfg.DetectorConfig(**kw),
        jcfg.DescriptorConfig(kind=desc), jcfg.MatchingConfig())
    tr = tpipe.get_correspondences(
        t(img1), t(img2), tcfg.DetectorConfig(**kw),
        tcfg.DescriptorConfig(kind=desc), tcfg.MatchingConfig())
    compare_aligned(jr, tr, match_share=share)


def _widths(name):
    """(dtype, width) of a descriptor row's output."""
    kind = tfeat.DESCRIPTOR_ALIASES[name]
    binary = {"BRIEF": 8, "LATCH": 8, "BGM": 8, "BINBOOST_64": 2,
              "BINBOOST_128": 4, "BINBOOST_256": 8, "RING": 16,
              "RING_LOG": 16, "MLDB": 16, "BOLD": 32}
    floats = {"SIFT": 128, "RIFF": 128, "MSURF": 64, "SURF64": 64,
              "LBGM": 64, "DAISY": 200, "VGG_120": 120, "VGG_80": 80,
              "VGG_64": 64, "VGG_48": 48}
    if kind in binary:
        return torch.int32, binary[kind]
    return torch.float32, floats[kind]


_SMALL_POSE = tcfg.PoseConfig(robust=tcfg.RobustConfig(batch_hypotheses=8,
                                                        max_batches=2))
_WALK = ([(d, "ORB", 1) for d in tfeat.DETECTOR_ALIASES]
         + [("ORB", "ORB", 3), ("BRISK", "ORB", 2)]
         + [("FAST", d, 1) for d in tfeat.DESCRIPTOR_ALIASES])


@pytest.mark.parametrize("det,desc,levels", _WALK,
                         ids=[f"{d}-{e}-{lv}" for d, e, lv in _WALK])
def test_registry_rows_run(det, desc, levels):
    """Each registry row through get_correspondences and run_batch (two
    small pairs) on the CPU: the row's descriptor width, finite poses."""
    img1, img2, K, _, _ = chip_smoke.render_scene(0, 192, 96)
    img3, img4, _, _, _ = chip_smoke.render_scene(1, 192, 96)
    det_cfg = tcfg.DetectorConfig(kind=det, max_keypoints=64,
                                  fast_threshold=12.0, column_bands=4,
                                  pyramid_levels=levels)
    desc_cfg = tcfg.DescriptorConfig(kind=desc)
    corr = tpipe.get_correspondences(t(img1), t(img2), det_cfg, desc_cfg)
    assert corr.mask.shape == (64,) and corr.kps1.xy.shape == (64, 2)
    d, _ = tfeat.compute_descriptors(t(img1), corr.kps1, desc_cfg,
                                     tfeat.detector_bands(det_cfg))
    dtype, width = _widths(desc)
    assert d.dtype == dtype and d.shape == (64, width)
    pipe = tpipe.StereoPipeline(det_cfg, desc_cfg, pose_cfg=_SMALL_POSE,
                                device="cpu")
    bcorr, pose = pipe.run_batch(np.stack([img1, img3]),
                                 np.stack([img2, img4]), K, K, np.zeros(5),
                                 np.zeros(5),
                                 torch.Generator().manual_seed(0))
    assert pose.R.shape == (2, 3, 3) and bcorr.mask.shape == (2, 64)
    assert bool(torch.isfinite(pose.R).all())
    for a, b in zip(corr, bcorr):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b[0])


@pytest.mark.parametrize("det,desc", [("FAST", "BOLD"),
                                      ("HARRIS", "LATCH")])
def test_run_batch_equals_run(det, desc):
    """run_batch on 2 pairs of the sequence against run on each pair, the
    same streams, on the CPU."""
    from matchinglib_poselib_torch.ops import robust

    pairs, K, _, _ = chip_smoke.render_sequence(0, frames=3, width=480,
                                                height=240)
    pose_cfg = tcfg.PoseConfig(robust=tcfg.RobustConfig(
        batch_hypotheses=32, max_batches=4))
    pipe = tpipe.StereoPipeline(
        tcfg.DetectorConfig(kind=det, max_keypoints=512,
                            fast_threshold=12.0),
        tcfg.DescriptorConfig(kind=desc), pose_cfg=pose_cfg, device="cpu")
    e_shape, d_shape = robust.sample_shapes(pose_cfg.robust)
    g = torch.Generator().manual_seed(5)
    uni = torch.rand((2, *e_shape), generator=g)
    deg = torch.rand((2, *d_shape), generator=g)
    imgs1 = np.stack([p[0] for p in pairs[1:3]])
    imgs2 = np.stack([p[1] for p in pairs[1:3]])
    corr, pose = pipe.run_batch(imgs1, imgs2, K, K, np.zeros(5), np.zeros(5),
                                uniforms=uni, degen_uniforms=deg)
    for i in range(2):
        c, p = pipe.run(imgs1[i], imgs2[i], K, K, np.zeros(5), np.zeros(5),
                        uniforms=uni[i], degen_uniforms=deg[i])
        assert_pair_equal(corr, pose, c, p, i)
    assert int(corr.n.min()) > 100
