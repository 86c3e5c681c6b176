"""Checkpoint / resume of the streaming state (``models/checkpoint.py``)
and the FileStorage readers (``utils/opencv_fs.py``): port vs JAX package.

- The port resumes its own checkpoint bit-exactly (the JAX package's
  contract, ``tests/test_checkpoint_profiling.py``), its generator state
  included.
- A checkpoint written by the JAX package is read by the port, which
  continues with the JAX run's states and poses (its samples from the
  checkpoint's ``prng_key`` through ``streams``). Resumed from the JAX
  package's checkpoint before every frame, the port gives the JAX
  frame's state, skip count, pool size and stability flags exactly.
  Neither format stores the SPRT history, so the lockstep run carries it
  over by hand.
- The committed FileStorage fixture parses to the same arrays in both
  packages and streams through both ``StereoRefine`` classes alike.
"""

import dataclasses
import os
import pathlib

import numpy as np
import pytest

import jax

from matchinglib_poselib_tpu.models import checkpoint as jck
from matchinglib_poselib_tpu.models.stereo_refine import (
    StereoRefine as JaxStereoRefine,
)
from matchinglib_poselib_tpu.utils import opencv_fs as jfs

from matchinglib_poselib_torch import convert
from matchinglib_poselib_torch.models import checkpoint as tck
from matchinglib_poselib_torch.models.stereo_refine import StereoRefine
from matchinglib_poselib_torch.utils import opencv_fs as tfs

from test_torch_helpers import (
    dir_angle_deg, jax_stereo_refine_streams, rot_chordal_deg,
)
from test_torch_stereo_refine import (
    K_CAM, both, check_frame, feed, make_cfg, stream,
)

FIXTURE = pathlib.Path(__file__).resolve().parents[1] / (
    "eval/fixtures/semireal_fs")


def _port(cfg, key=None, seed=0):
    """A port StereoRefine on the CPU, sampling the JAX stream of `key`
    (a raw JAX key) or of PRNGKey(seed)."""
    ts = StereoRefine(K_CAM, K_CAM, cfg=convert.config_from_jax(cfg),
                      device="cpu",
                      streams=jax_stereo_refine_streams(seed, cfg, key=key))
    ts.min_pool_size_stable = 300
    return ts


def test_port_checkpoint_resumes_bit_exact(tmp_path):
    """Run A: 3 frames, save, 3 more. Run B (another seed) restores the
    checkpoint, its generator state included, and continues: the same
    bits."""
    cfg = convert.config_from_jax(make_cfg())
    frames = stream(13)[:6]
    a = StereoRefine(K_CAM, K_CAM, cfg=cfg, seed=7, device="cpu")
    for f in frames[:3]:
        feed(a, f)
    ckpt = tmp_path / "sr.npz"
    tck.save_stereo_refine(a, ckpt, seed=7)
    res_a = [feed(a, f) for f in frames[3:]]
    b = StereoRefine(K_CAM, K_CAM, cfg=cfg, seed=99, device="cpu")
    tck.load_stereo_refine(b, ckpt)
    res_b = [feed(b, f) for f in frames[3:]]
    for ra, rb in zip(res_a, res_b):
        assert ra.state == rb.state
        np.testing.assert_array_equal(ra.R, rb.R)
        np.testing.assert_array_equal(ra.t, rb.t)
        assert ra.pool_size == rb.pool_size
    assert a.frame_idx == b.frame_idx
    np.testing.assert_array_equal(a.pool.x1.numpy(), b.pool.x1.numpy())
    assert sorted(os.listdir(tmp_path)) == ["sr.npz"]  # no temporary left


def test_jax_checkpoint_continues_in_the_port(tmp_path):
    """The JAX package runs the 16-frame stream and saves after frame 4;
    the port reads that checkpoint and runs frames 5-16 with the samples
    of its prng_key: the JAX run's states and poses."""
    cfg = make_cfg()
    frames = stream(11)
    js, _ = both(cfg)
    for f in frames[:4]:
        feed(js, f)
    ckpt = tmp_path / "jax.npz"
    jck.save_stereo_refine(js, ckpt)
    ts = _port(cfg, key=np.load(ckpt)["prng_key"])
    tck.load_stereo_refine(ts, ckpt)
    assert ts.frame_idx == 4 and int(ts.pool.n_valid) == int(js.pool.n_valid)
    states, flips = [], []
    for i, f in enumerate(frames[4:], start=4):
        a, b = feed(js, f), feed(ts, f)
        check_frame(i, a, b, js, ts, cfg, flips)
        states.append(a.state)
    assert "skipped" in states and "reinit" in states


def test_resumed_every_frame_from_jax_matches_exactly(tmp_path):
    """Lockstep: before every frame the port is restored from the JAX
    package's checkpoint (plus its SPRT history, which the format does not
    hold) and runs that one frame; state, skip count, pool size and both
    stability flags equal the JAX frame's, the pose within 0.1 / 0.5 deg,
    on a stream with a skip, a reinit and stable poses."""
    cfg = make_cfg()
    js, _ = both(cfg)
    ckpt = tmp_path / "step.npz"
    seen = set()
    for i, f in enumerate(stream(11)):
        jck.save_stereo_refine(js, ckpt)
        ts = _port(cfg, key=np.asarray(jax.random.key_data(js._key)))
        tck.load_stereo_refine(ts, ckpt)
        ts.sprt_history = list(js.sprt_history)
        ts._last_delta = js._last_delta
        a, b = feed(js, f), feed(ts, f)
        check_frame(i, a, b, js, ts, cfg, [])
        assert (a.pool_size, a.pose_is_stable, a.most_likely_pose_stable) == (
            b.pool_size, b.pose_is_stable, b.most_likely_pose_stable), i
        seen.add(a.state)
        seen.add(("stable", a.pose_is_stable))
    assert {"init", "refined", "skipped", "reinit", ("stable", True)} <= seen


def test_capacity_mismatch_raises_and_the_jax_package_reads_the_port(
        tmp_path):
    cfg = make_cfg()
    small = dataclasses.replace(cfg, max_pool_correspondences=512)
    frames = stream(11)[:2]
    ts = _port(cfg)
    for f in frames:
        feed(ts, f)
    ckpt = tmp_path / "port.npz"
    tck.save_stereo_refine(ts, ckpt)
    with pytest.raises(ValueError):
        tck.load_stereo_refine(_port(small), ckpt)
    js, _ = both(cfg)
    jck.save_stereo_refine(js, tmp_path / "jax.npz")
    with pytest.raises(ValueError):
        tck.load_stereo_refine(_port(small), tmp_path / "jax.npz")
    # the port's file holds every key of the JAX format
    back = JaxStereoRefine(K_CAM, K_CAM, cfg=cfg)
    jck.load_stereo_refine(back, ckpt)
    assert int(back.pool.n_valid) == int(ts.pool.n_valid)
    np.testing.assert_array_equal(np.asarray(back.pool.pt1),
                                  ts.pool.pt1.numpy())
    assert back.frame_idx == ts.frame_idx == 2


def _fixture_frames():
    cams = sorted(FIXTURE.glob("sequSingleFrameData_*.yaml.gz"))
    matches = sorted(FIXTURE.glob("matchSingleFrameData_*.yaml.gz"))
    assert len(cams) == len(matches) == 3
    return list(zip(cams, matches))


def test_fixture_readers_match_jax_exactly():
    for cam, match in _fixture_frames():
        jc, tc = jfs.read_cam_pars(cam), tfs.read_cam_pars(cam)
        jm, tm = jfs.read_matches(match), tfs.read_matches(match)
        for d_j, d_t in ((jc, tc), (jm, tm),
                         (jfs.sequ_frame(jc, jm), tfs.sequ_frame(tc, tm))):
            assert d_j.keys() == d_t.keys()
            for k in d_j:
                vj, vt = d_j[k], d_t[k]
                if isinstance(vj, list):
                    assert len(vj) == len(vt)
                    for x, y in zip(vj, vt):
                        np.testing.assert_array_equal(x, y)
                elif isinstance(vj, np.ndarray):
                    assert vj.dtype == vt.dtype and vj.shape == vt.shape, k
                    np.testing.assert_array_equal(vj, vt)
                else:
                    assert vj == vt, k


def test_fixture_frames_through_both_stereo_refines():
    """The three SemiRealSequence frames (300 correspondences, GT pose and
    inlier masks) as the nomatch CLI feeds them: the same result per
    frame in both packages (``check_frame``: the pool size within 1%, as
    the JAX package's post-seeding dedup decides on rounding noise; see
    tests/test_torch_stereo_refine.py), and the GT pose within 1 / 5
    deg."""
    frames = [tfs.sequ_frame(tfs.read_cam_pars(c), tfs.read_matches(m))
              for c, m in _fixture_frames()]
    cfg = make_cfg()
    f0 = frames[0]
    js = JaxStereoRefine(f0["K1"], f0["K2"], cfg=cfg, seed=0)
    ts = StereoRefine(f0["K1"], f0["K2"], cfg=convert.config_from_jax(cfg),
                      device="cpu", streams=jax_stereo_refine_streams(0, cfg))
    flips = []
    for i, fr in enumerate(frames):
        k = len(fr["pts1"])
        ones = np.ones(k, np.float32)
        a = js.add_new_correspondences(fr["pts1"], fr["pts2"], ones, ones)
        b = ts.add_new_correspondences(fr["pts1"], fr["pts2"], ones, ones)
        check_frame(i, a, b, js, ts, cfg, flips)
        assert a.state in ("init", "refined", "robust")
        assert rot_chordal_deg(fr["R_GT"], b.R) < 1.0
        assert dir_angle_deg(fr["t_GT"], b.t) < 5.0
