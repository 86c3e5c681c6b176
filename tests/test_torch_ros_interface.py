"""Port parity: the ROS node's host layer and the flagship entry point,
against the JAX package on the CPU.

``params_to_configs`` field for field for every launch parameter;
``MatchingPoselibNode`` with ``device="cpu"`` over frames of
``chip_smoke.render_sequence`` at 240 x 320 (1024 keypoints) beside the
JAX node on the same images, the port fed the JAX node's samples
(``fold_in(PRNGKey(0), frame)`` per frame through
``apps.common.frame_streams``; a ``StereoRefine`` seeded 0 through
``apps.common.stereo_refine_streams``). Tolerances: R within 0.1 deg and
the translation direction within 0.5 deg of the JAX node's,
``n_inliers`` within 1%, the evaluate / republish pattern of
``evStepStereoStable`` equal. The scene does not make the stereo pose
stable within a few frames at this size, so the republish pattern is also
run with both packages' stability check forced to "stable".
"""

import dataclasses
import enum

import numpy as np
import pytest
import torch

from matchinglib_poselib_tpu.apps import ros_interface as jri
from matchinglib_poselib_tpu.models import stereo_refine as jsr
from matchinglib_poselib_torch.apps import common
from matchinglib_poselib_torch.apps import ros_interface as tri
from matchinglib_poselib_torch.models import stereo_refine as tsr
from matchinglib_poselib_torch import entry as tentry

import chip_smoke
from test_torch_helpers import (
    dir_angle_deg, jax_cli_frame_streams, jax_stereo_refine_streams,
    rot_chordal_deg,
)

ROT_DEG, TANG_DEG = 0.1, 0.5
INLIER_RTOL = 0.01
NODE_PARAMS = {"nrFeatures": 1024}
STEREO_PARAMS = {"nrFeatures": 1024, "stereoRef": "1",
                 "evStepStereoStable": "2"}
# every launch parameter, with values off the defaults
ALL_PARAMS = {
    "f_detect": "FAST", "d_extr": "ORB", "matcher": "GMBSOF",
    "nrFeatures": "512", "f_detect_th": "15.5", "subPixRef": "1",
    "ratioTest": "0", "DynKeyP": "1", "th": "1.2", "RobMethod": "RANSAC",
    "batch_hypotheses": "64", "max_batches": "3", "refineRT": "61",
    "BART": "1", "stereoRef": "1", "evStepStereoStable": "2",
    "useMostLikelyPose": "1",
}


def _plain(x):
    """Configs of either package -> comparable plain values."""
    if dataclasses.is_dataclass(x):
        return {f.name: _plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, enum.Enum):
        return (type(x).__name__, x.name)
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    return x


@pytest.fixture(scope="module")
def frames():
    pairs, K, R, t = chip_smoke.render_sequence(0, 3, 320, 240)
    return pairs, K, R, t


@pytest.fixture
def jax_streams(monkeypatch):
    """The port's node draws the JAX node's samples."""
    monkeypatch.setattr(common, "frame_streams", jax_cli_frame_streams)
    monkeypatch.setattr(common, "stereo_refine_streams",
                        lambda cfg: jax_stereo_refine_streams(0, cfg))


def _run(node_cls, params, frames_, n, **kw):
    pairs, K, _, _ = frames_
    published = []
    node = node_cls(params=params, on_pose=published.append, **kw)
    node.set_calibration(K, K, np.zeros(5), np.zeros(5))
    msgs = [node.handle_stereo_pair(*pairs[i % len(pairs)]) for i in range(n)]
    assert published == msgs
    # the frames that republished the message before them
    pattern = [i > 0 and msgs[i] is msgs[i - 1] for i in range(n)]
    return msgs, pattern


def _check_msgs(tmsgs, jmsgs):
    for tm, jm in zip(tmsgs, jmsgs):
        assert rot_chordal_deg(tm.R, jm.R) < ROT_DEG
        assert dir_angle_deg(tm.t, jm.t) < TANG_DEG
        assert abs(tm.n_inliers - jm.n_inliers) <= INLIER_RTOL * max(
            jm.n_inliers, 1)
        assert tm.pose_is_stable == jm.pose_is_stable
        assert tm.most_likely_stable == jm.most_likely_stable


@pytest.mark.parametrize("key", sorted(jri._PARAM_SCHEMA))
def test_params_to_configs_per_key(key):
    assert set(tri._PARAM_SCHEMA) == set(jri._PARAM_SCHEMA)
    params = {key: ALL_PARAMS[key]}
    assert _plain(tri.params_to_configs(params)) == _plain(
        jri.params_to_configs(params))


@pytest.mark.parametrize("refine_rt", ["00", "22", "5", "61", "31", "9"])
def test_params_to_configs_all_keys(refine_rt):
    params = dict(ALL_PARAMS, refineRT=refine_rt)
    assert _plain(tri.params_to_configs(params)) == _plain(
        jri.params_to_configs(params))


def test_params_rejected():
    with pytest.raises(KeyError):
        tri.params_to_configs({"definitely_not_a_param": 1})
    # a negative threshold is taken, as by the JAX package (the FAST
    # kernel has an instantiation for t < 0)
    params = {"f_detect_th": "-1"}
    assert _plain(tri.params_to_configs(params)) == _plain(
        jri.params_to_configs(params))
    assert tri.params_to_configs(params)["det"].fast_threshold == -1.0
    assert tri.params_to_configs({"f_detect_th": "0"})["det"] \
        .fast_threshold == 0.0


def test_node_device():
    if torch.cuda.is_available():
        assert tri.MatchingPoselibNode().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            tri.MatchingPoselibNode()
        with pytest.raises(RuntimeError):
            tentry.entry()
    assert tri.MatchingPoselibNode(device="cpu").device.type == "cpu"


def test_node_needs_calibration_and_spin_needs_rospy():
    node = tri.MatchingPoselibNode(device="cpu")
    with pytest.raises(RuntimeError, match="set_calibration"):
        node.handle_stereo_pair(np.zeros((8, 8)), np.zeros((8, 8)))
    with pytest.raises(RuntimeError, match="rospy"):
        node.spin()


def test_node_frames_match_jax(frames, jax_streams):
    jmsgs, jpat = _run(jri.MatchingPoselibNode, NODE_PARAMS, frames, 2)
    tmsgs, tpat = _run(tri.MatchingPoselibNode, NODE_PARAMS, frames, 2,
                       device="cpu")
    assert tpat == jpat == [False, False]
    _check_msgs(tmsgs, jmsgs)
    for m in tmsgs:
        assert m.R.dtype == np.float64 and m.R.shape == (3, 3)


def test_node_reconfigure_rebuilds_only_on_change():
    node = tri.MatchingPoselibNode(params={"nrFeatures": 256}, device="cpu")
    det, pose = node._det, node._pose
    node.reconfigure({"nrFeatures": 256})
    assert node._det is det and node._pose is pose
    node.reconfigure({"nrFeatures": 128})
    assert node._det.max_keypoints == 128 and node._det is not det
    det = node._det
    node.reconfigure({})
    assert node._det is det


def test_node_stereo_ref_matches_jax(frames, jax_streams):
    jmsgs, jpat = _run(jri.MatchingPoselibNode, STEREO_PARAMS, frames, 3)
    tmsgs, tpat = _run(tri.MatchingPoselibNode, STEREO_PARAMS, frames, 3,
                       device="cpu")
    assert tpat == jpat
    _check_msgs(tmsgs, jmsgs)


def test_node_republish_pattern_matches_jax(frames, jax_streams,
                                            monkeypatch):
    """evStepStereoStable = 2 with the stability check forced to
    "stable": frames 0 and 3 evaluate, 1-2 republish the held pose; with
    useMostLikelyPose the message carries the most likely pose."""
    for mod in (jsr, tsr):
        check = mod.StereoRefine._check_pose_stability

        def forced(self, check=check):
            check(self)
            self.pose_is_stable = True

        monkeypatch.setattr(mod.StereoRefine, "_check_pose_stability",
                            forced)
    params = dict(STEREO_PARAMS, useMostLikelyPose="1")
    jmsgs, jpat = _run(jri.MatchingPoselibNode, params, frames, 4)
    tmsgs, tpat = _run(tri.MatchingPoselibNode, params, frames, 4,
                       device="cpu")
    assert tpat == jpat == [False, True, True, False]
    _check_msgs(tmsgs, jmsgs)
    for m in tmsgs:
        np.testing.assert_array_equal(m.R, m.R_most_likely)


def test_entry_runs_on_the_cpu():
    fn, args = tentry.entry(device="cpu")
    img1, img2, K1, K2, d1, d2, gen = args
    assert img1.shape == (tentry.HEIGHT, tentry.WIDTH)
    assert all(a.device.type == "cpu" for a in args[:-1])
    assert gen.device.type == "cpu"
    R, t, n_inl, n_corr = fn(*args)
    assert R.shape == (3, 3) and t.shape == (3,)
    assert 0 <= int(n_inl) <= int(n_corr) <= tentry.MAX_KEYPOINTS
    # the step at a small size on the same kind of inputs
    step = tentry.flagship_step(max_keypoints=128, hypotheses=32)
    R, t, n_inl, n_corr = step(img1[:96, :128], img2[:96, :128], K1, K2, d1,
                               d2, gen)
    assert R.shape == (3, 3) and t.shape == (3,)
    assert bool(torch.isfinite(R).all()) and bool(torch.isfinite(t).all())
    assert 0 <= int(n_inl) <= int(n_corr) <= 128
