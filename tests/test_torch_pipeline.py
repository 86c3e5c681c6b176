"""The slice as a whole: StereoPipeline.run of the port vs the JAX package
on a seeded synthetic scene with a planted pose (chip_smoke.render_scene).

Both run at 240x480 with 512 keypoint slots in 8 column bands and 32 x 4
five-point hypotheses; the port draws the JAX package's own uniforms.
Tolerances: correspondence masks agree on >= 99% of slots and the matched
index agrees on every slot both keep (descriptor bits can differ only at
an orientation-bin edge); poses agree within 0.1 deg (rotation) and
0.5 deg (translation direction) — a slot or two of difference in the
correspondence set moves the least-squares refits that much; and both
poses meet the accuracy bars of tests/test_pipeline.py against the
planted pose (1 deg, 5 deg).
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
    dir_angle_deg, jax_degen_uniforms, jax_uniforms, n, rot_angle_deg, t,
)


def _run_both(height, width, kp, bands, batch, batches, seed=0):
    img1, img2, K, R, tt = render_scene(seed, width, height)
    det = dict(kind="FAST", max_keypoints=kp, fast_threshold=12.0,
               column_bands=bands)
    rob = dict(batch_hypotheses=batch, max_batches=batches)
    key = jax.random.PRNGKey(seed)
    jcorr = jp.get_correspondences(
        jnp.asarray(img1), jnp.asarray(img2), jcfg.DetectorConfig(**det),
        jcfg.DescriptorConfig(), jcfg.MatchingConfig())
    jpose = jp.estimate_pose(
        jcorr.pts1, jcorr.pts2, jcorr.mask, jcorr.quality, jnp.asarray(K),
        jnp.asarray(K), jnp.zeros(5), jnp.zeros(5),
        jcfg.PoseConfig(robust=jcfg.RobustConfig(**rob)), key)
    pipe = tp.StereoPipeline(
        tcfg.DetectorConfig(**det), tcfg.DescriptorConfig(),
        tcfg.MatchingConfig(),
        tcfg.PoseConfig(robust=tcfg.RobustConfig(**rob)))
    tcorr, tpose = pipe.run(
        t(img1), t(img2), t(K), t(K), torch.zeros(5), torch.zeros(5),
        uniforms=jax_uniforms(key, batches, batch, 5),
        degen_uniforms=jax_degen_uniforms(key, batch))
    return jcorr, jpose, tcorr, tpose, R, tt, pipe


def _check(jcorr, jpose, tcorr, tpose, R, tt):
    jm, tm = np.asarray(jcorr.mask), n(tcorr.mask)
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
    return int(tm.sum()), int(tpose.n_inliers)


def test_stereo_pipeline_run_matches_jax_on_synthetic_scene():
    jcorr, jpose, tcorr, tpose, R, tt, pipe = _run_both(240, 480, 512, 8,
                                                        32, 4)
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
    cfgs = (tcfg.DetectorConfig(max_keypoints=128, fast_threshold=12.0,
                                column_bands=4),
            tcfg.DescriptorConfig(), tcfg.MatchingConfig(),
            tcfg.PoseConfig(robust=tcfg.RobustConfig(batch_hypotheses=16,
                                                     max_batches=2)))
    outs = []
    for kw in ({}, dict(descriptor_tables=dtab, solver_tables=stab)):
        pipe = tp.StereoPipeline(*cfgs, **kw)
        outs.append(pipe.run(t(img1), t(img2), t(K), t(K), torch.zeros(5),
                             torch.zeros(5),
                             torch.Generator().manual_seed(3)))
    (c0, p0), (c1, p1) = outs
    assert torch.equal(c0.mask, c1.mask) and torch.equal(c0.pts2, c1.pts2)
    assert torch.equal(p0.R, p1.R) and torch.equal(p0.t, p1.t)


@pytest.mark.slow
def test_stereo_pipeline_full_size_parity():
    """Flagship config at 1392x512 (the chip_smoke workload) on the CPU."""
    jcorr, jpose, tcorr, tpose, R, tt, _ = _run_both(512, 1392, 2048, 16,
                                                     96, 12)
    n_corr, n_inl = _check(jcorr, jpose, tcorr, tpose, R, tt)
    assert n_corr >= 300 and n_inl >= 200
