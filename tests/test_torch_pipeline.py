"""End to end: StereoPipeline.run of the port vs the JAX
package on a seeded synthetic scene with a planted pose
(chip_smoke.render_scene).

The flagship config (FAST/ORB) runs at 240x480 with 512 keypoint slots in
8 column bands; the float configs SIFT/SIFT and SURF/SURF (GMBSOF, no GMS)
at 240x480 with 512 slots, and SIFT/SIFT + GMS at 320x800 with 1024 slots
(at 240x480 GMS keeps almost no match). All use 32 x 4 five-point
hypotheses; the port draws the JAX package's own uniforms.
Tolerances: correspondence masks agree on >= 99% of slots and the matched
partner agrees on every slot both keep (descriptor bits can differ only at
an orientation-bin edge); poses agree within 0.1 deg (rotation) and
0.5 deg (translation direction) — a slot or two of difference in the
correspondence set moves the least-squares refits that much; and both
poses meet the accuracy bars of tests/test_pipeline.py against the
planted pose (1 deg, 5 deg). FAST keypoint slots agree exactly. The
scale-space detectors can find an extremum on an f32 near tie on one side
only, which shifts every later slot (test_torch_scale_space.py): there,
>= 99% of the keypoints must be found on both sides, correspondence slots
are compared after aligning the keypoints by position, and >= 98% of the
slots must agree in mask and, where both keep, partner — a flipped
keypoint of image 2 takes the matches of the queries whose partner it
was, and moves the SOF field's statistics a little.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from matchinglib_poselib_tpu import config as jcfg
from matchinglib_poselib_tpu.models import pipeline as jp

from matchinglib_poselib_torch import config as tcfg
from matchinglib_poselib_torch.models import pipeline as tp

from chip_smoke import render_scene
from test_torch_helpers import (
    align_slots, aligned_fraction, dir_angle_deg, jax_degen_uniforms,
    jax_uniforms, n, rot_angle_deg, t,
)


def _fast(kp, bands):
    return dict(kind="FAST", max_keypoints=kp, fast_threshold=12.0,
                column_bands=bands)


def _run_both(height, width, det, batch, batches, seed=0, desc=None,
              match=None):
    img1, img2, K, R, tt = render_scene(seed, width, height)
    desc = desc or {}
    match = match or {}
    rob = dict(batch_hypotheses=batch, max_batches=batches)
    key = jax.random.PRNGKey(seed)
    jcorr = jp.get_correspondences(
        jnp.asarray(img1), jnp.asarray(img2), jcfg.DetectorConfig(**det),
        jcfg.DescriptorConfig(**desc), jcfg.MatchingConfig(**match))
    jpose = jp.estimate_pose(
        jcorr.pts1, jcorr.pts2, jcorr.mask, jcorr.quality, jnp.asarray(K),
        jnp.asarray(K), jnp.zeros(5), jnp.zeros(5),
        jcfg.PoseConfig(robust=jcfg.RobustConfig(**rob)), key)
    pipe = tp.StereoPipeline(
        tcfg.DetectorConfig(**det), tcfg.DescriptorConfig(**desc),
        tcfg.MatchingConfig(**match),
        tcfg.PoseConfig(robust=tcfg.RobustConfig(**rob)), device="cpu")
    tcorr, tpose = pipe.run(
        t(img1), t(img2), t(K), t(K), torch.zeros(5), torch.zeros(5),
        uniforms=jax_uniforms(key, batches, batch, 5),
        degen_uniforms=jax_degen_uniforms(key, batch))
    return jcorr, jpose, tcorr, tpose, R, tt, pipe


def _aligned(jcorr, tcorr):
    """Port correspondence mask and partners moved to the JAX slots of the
    same image-1 keypoints (unmatched slots: no correspondence), plus the
    number of port correspondences on keypoints JAX does not have."""
    for side in ("kps1", "kps2"):
        jk, tk = getattr(jcorr, side), getattr(tcorr, side)
        frac, missing = aligned_fraction(
            align_slots(jk.xy, jk.mask, n(tk.xy), n(tk.mask)), jk.mask,
            n(tk.mask))
        assert frac >= 0.99, f"{side}: {missing} keypoints on one side only"
    perm = align_slots(jcorr.kps1.xy, jcorr.kps1.mask, n(tcorr.kps1.xy),
                       n(tcorr.kps1.mask))
    p = np.maximum(perm, 0)
    tm = n(tcorr.mask)
    only_port = np.ones(len(tm), bool)
    only_port[perm[perm >= 0]] = False
    return (tm[p] & (perm >= 0), n(tcorr.pts2)[p],
            int((tm & only_port).sum()))


def _check(jcorr, jpose, tcorr, tpose, R, tt, align=False):
    jm = np.asarray(jcorr.mask)
    if align:
        tm, tpts2, extra = _aligned(jcorr, tcorr)
        same = np.abs(tpts2 - np.asarray(jcorr.pts2)).max(-1) <= 1e-5
        agree = (jm == tm) & (~(jm & tm) | same)
        assert agree.sum() - extra >= 0.98 * len(jm), (
            f"{(~agree).sum()} slots differ, {extra} port-only")
    else:
        tm = n(tcorr.mask)
        assert (jm == tm).mean() >= 0.99
        both = jm & tm
        np.testing.assert_allclose(n(tcorr.pts2)[both],
                                   np.asarray(jcorr.pts2)[both], atol=1e-5)
        np.testing.assert_array_equal(n(tcorr.kps1.mask),
                                      np.asarray(jcorr.kps1.mask))
    assert rot_angle_deg(np.asarray(jpose.R), n(tpose.R)) < 0.1
    assert dir_angle_deg(np.asarray(jpose.t), n(tpose.t)) < 0.5
    for pose in (jpose, tpose):
        assert rot_angle_deg(R, np.asarray(n(pose.R))) < 1.0
        assert dir_angle_deg(tt, np.asarray(n(pose.t))) < 5.0
    return int(n(tcorr.mask).sum()), int(tpose.n_inliers)


def test_stereo_pipeline_run_matches_jax_on_synthetic_scene():
    jcorr, jpose, tcorr, tpose, R, tt, pipe = _run_both(240, 480,
                                                        _fast(512, 8), 32, 4)
    n_corr, n_inl = _check(jcorr, jpose, tcorr, tpose, R, tt)
    assert n_corr >= 100 and n_inl >= 80
    assert set(pipe.timer.times_ms) == {
        "keypoints", "descriptors", "matching", "robEstimationAndRef"}
    assert not bool(tpose.is_degenerate)


def test_pipeline_runs_on_tables_loaded_from_the_jax_arrays():
    """convert.tables_from_numpy carries the JAX package's seeded tables
    into the port: the same run, bit for bit, as with the regenerated
    defaults."""
    from matchinglib_poselib_tpu.ops import features as jfeat
    from matchinglib_poselib_tpu.ops import solvers as jsolv
    from matchinglib_poselib_torch import convert

    img1, img2, K, _, _ = render_scene(1, 256, 128)
    dtab, stab = convert.tables_from_numpy(
        jfeat._ORB_IDX, np.asarray(jsolv._INTERP_PTS),
        np.asarray(jsolv._VINV_T_NISTER))
    cfgs = (tcfg.DetectorConfig(**_fast(128, 4)),
            tcfg.DescriptorConfig(), tcfg.MatchingConfig(),
            tcfg.PoseConfig(robust=tcfg.RobustConfig(batch_hypotheses=16,
                                                     max_batches=2)))
    outs = []
    for kw in ({}, dict(descriptor_tables=dtab, solver_tables=stab)):
        pipe = tp.StereoPipeline(*cfgs, **kw, device="cpu")
        outs.append(pipe.run(t(img1), t(img2), t(K), t(K), torch.zeros(5),
                             torch.zeros(5),
                             torch.Generator().manual_seed(3)))
    (c0, p0), (c1, p1) = outs
    assert torch.equal(c0.mask, c1.mask) and torch.equal(c0.pts2, c1.pts2)
    assert torch.equal(p0.R, p1.R) and torch.equal(p0.t, p1.t)


@pytest.mark.slow
def test_stereo_pipeline_full_size_parity():
    """Flagship config at 1392x512 (the chip_smoke workload) on the CPU."""
    jcorr, jpose, tcorr, tpose, R, tt, _ = _run_both(512, 1392,
                                                     _fast(2048, 16), 96, 12)
    n_corr, n_inl = _check(jcorr, jpose, tcorr, tpose, R, tt)
    assert n_corr >= 300 and n_inl >= 200


@pytest.mark.parametrize("kind", ["SIFT", "SURF"])
def test_float_descriptor_pipeline_matches_jax(kind):
    """SIFT/SIFT and SURF/SURF with GMBSOF (squared-L2 2-NN, no GMS)."""
    jcorr, jpose, tcorr, tpose, R, tt, _ = _run_both(
        240, 480, dict(kind=kind, max_keypoints=512), 32, 4,
        desc=dict(kind=kind))
    n_corr, n_inl = _check(jcorr, jpose, tcorr, tpose, R, tt, align=True)
    assert n_corr >= 100 and n_inl >= 80


def test_sift_gms_pipeline_matches_jax():
    """SIFT/SIFT + GMBSOF + GMS: the test that carries GMS through the
    whole pipeline (about half the JAX package's 326 correspondences and
    263 inliers on this pair)."""
    jcorr, jpose, tcorr, tpose, R, tt, _ = _run_both(
        320, 800, dict(kind="SIFT", max_keypoints=1024), 32, 4,
        desc=dict(kind="SIFT"), match=dict(gms_filter=True))
    n_corr, n_inl = _check(jcorr, jpose, tcorr, tpose, R, tt, align=True)
    assert n_corr >= 150 and n_inl >= 100


@pytest.mark.slow
def test_sift_gms_pipeline_full_size_parity():
    """SIFT/SIFT + GMS at 1392x512, 2048 slots, 96 x 12 (the chip_smoke
    float workload) on the CPU."""
    jcorr, jpose, tcorr, tpose, R, tt, _ = _run_both(
        512, 1392, dict(kind="SIFT", max_keypoints=2048), 96, 12,
        desc=dict(kind="SIFT"), match=dict(gms_filter=True))
    n_corr, n_inl = _check(jcorr, jpose, tcorr, tpose, R, tt, align=True)
    assert n_corr >= 300 and n_inl >= 200


def test_pipeline_on_cuda_raises_without_a_card():
    """The entry point runs on the card unless asked for the CPU; with no
    card it raises instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.StereoPipeline()
    with pytest.raises(RuntimeError):
        tp.StereoPipeline(device="cuda:0")
