"""ROS interface: a continuous matching and pose node (port of
``apps/ros_interface.py``).

The reference ships a separate repo (matchinglib_poselib_ros,
README.md:769-777) whose node reads stereo images, computes matches and
poses with the library, and takes every pipeline option from a launch
file and dynamic-reconfigure updates. This module is that interface:

- ``params_to_configs``: the flat launch-file / dynamic-reconfigure
  parameters -> the typed config tree (config.py), with the reference
  executables' option names.
- ``MatchingPoselibNode``: the node, on the card unless ``device="cpu"``.
  ``handle_stereo_pair`` is the image callback (usable without ROS);
  ``reconfigure`` applies a parameter delta and rebuilds the configs only
  when a value changed; with ``stereoRef`` it keeps a ``StereoRefine``
  and publishes the reference's stability outputs
  (stereo_pose_refinement.h:127-176).
- ``spin()`` wires the callback to image topics when ``rospy`` exists;
  everything else works without it.

Sampling: the pose stage draws from one ``torch.Generator`` seeded 0,
frame after frame, unless ``apps.common.frame_streams`` returns explicit
streams for the frame (the JAX node samples frame i under
``fold_in(PRNGKey(0), i)``); the ``StereoRefine`` takes
``apps.common.stereo_refine_streams``, as the CLIs do.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from matchinglib_poselib_torch.apps import common
from matchinglib_poselib_torch.config import (
    BAConfig,
    DescriptorConfig,
    DetectorConfig,
    MatchingConfig,
    PoseConfig,
    PoseEstimator,
    RefinementConfig,
    RobustConfig,
    StereoRefineConfig,
)
from matchinglib_poselib_torch.models import pipeline
from matchinglib_poselib_torch.models.stereo_refine import StereoRefine


def _flag(v) -> bool:
    return bool(int(v))


#: launch-file parameter -> (config group, field, cast). The names are the
#: reference executables' options (poselib-test main.cpp: --f_detect,
#: --d_extr, --matcher, --nrFeatures, --subPixRef, --RobMethod, --th,
#: --refineRT, --BART ...).
_PARAM_SCHEMA = {
    "f_detect": ("det", "kind", str),
    "d_extr": ("desc", "kind", str),
    "matcher": ("match", "matcher_name", str),
    "nrFeatures": ("det", "max_keypoints", int),
    "f_detect_th": ("det", "fast_threshold", float),
    "subPixRef": ("match", "subpix_refine", _flag),
    "ratioTest": ("match", "ratio_test", _flag),
    "DynKeyP": (None, None, None),  # accepted, implied by grid top-k
    "th": ("robust", "threshold_px", float),
    "RobMethod": ("robust", "estimator_name", str),
    "batch_hypotheses": ("robust", "batch_hypotheses", int),
    "max_batches": ("robust", "max_batches", int),
    "refineRT": ("refine", "refine_rt_code", str),
    "BART": ("ba", "enabled", _flag),
    "stereoRef": ("node", "stereo_ref", _flag),
    "evStepStereoStable": ("node", "ev_step_stable", int),
    "useMostLikelyPose": ("node", "use_most_likely", _flag),
}


def params_to_configs(params: dict) -> dict:
    """Flat launch / dynamic-reconfigure params -> {"det", "desc",
    "match", "pose", "node"}. An unknown name raises ``KeyError``."""
    groups = {g: {} for g in ("det", "desc", "match", "robust", "refine",
                              "ba", "node")}
    for name, value in params.items():
        if name not in _PARAM_SCHEMA:
            raise KeyError(f"unknown parameter '{name}'")
        group, field, cast = _PARAM_SCHEMA[name]
        if group is not None:
            groups[group][field] = cast(value)

    rb = groups["robust"]
    if "estimator_name" in rb:
        rb["estimator"] = PoseEstimator(rb.pop("estimator_name"))
    # refineRT two-digit code (poselib-test --refineRT, main.cpp:339-354):
    # refinement algorithm (Kneip instead of BA on 6), then weighting
    rf = groups["refine"]
    node = groups.pop("node")
    if "refine_rt_code" in rf:
        code = (rf.pop("refine_rt_code") + "22")[:2]
        enabled, solver, kneip_iba = common._REFINE_ALG.get(
            code[0], (True, None, False))
        rf["enabled"] = enabled
        if solver is not None:
            rf["solver"] = solver
        if code[1] in common._REFINE_W:
            rf["weights"] = common._REFINE_W[code[1]]
        node["kneip_instead_ba"] = kneip_iba
    pose = PoseConfig(
        robust=RobustConfig(**groups["robust"]),
        refine=RefinementConfig(**groups["refine"]),
        ba=BAConfig(**groups["ba"]),
    )
    return {"det": DetectorConfig(**groups["det"]),
            "desc": DescriptorConfig(**groups["desc"]),
            "match": MatchingConfig(**groups["match"]),
            "pose": pose, "node": node}


@dataclasses.dataclass
class PoseMsg:
    """Published pose: R / t and the stability flags."""

    R: np.ndarray
    t: np.ndarray
    n_inliers: int
    inlier_ratio: float
    pose_is_stable: bool = False
    R_most_likely: np.ndarray | None = None
    t_most_likely: np.ndarray | None = None
    most_likely_stable: bool = False


class MatchingPoselibNode:
    """Continuous stereo matching and pose node.

    The transport-free core of the reference's ROS node: feed stereo
    frames to ``handle_stereo_pair``, read ``PoseMsg`` results;
    ``reconfigure`` mirrors dynamic_reconfigure. Runs on `device`: the
    card unless the caller passes ``device="cpu"`` (no card:
    ``RuntimeError``).
    """

    def __init__(self, params: dict | None = None,
                 on_pose: Callable[[PoseMsg], None] | None = None,
                 device: torch.device | str = "cuda"):
        self.device = common.cli_device(device, "MatchingPoselibNode")
        self._params = dict(params or {})
        self._on_pose = on_pose
        self._frame_idx = 0
        self._last_eval_idx = 0
        self._last_msg: PoseMsg | None = None
        self._calib = None
        self._generator = torch.Generator(device=self.device).manual_seed(0)
        self._rebuild()

    # -- configuration -------------------------------------------------
    def _rebuild(self):
        cfg = params_to_configs(self._params)
        self._det, self._desc = cfg["det"], cfg["desc"]
        self._match, self._pose = cfg["match"], cfg["pose"]
        self._node = cfg["node"]
        self._refine = None  # built once calibration is known

    def reconfigure(self, changes: dict):
        """dynamic_reconfigure callback: apply a parameter delta."""
        new = dict(self._params)
        new.update(changes)
        if new != self._params:
            self._params = new
            self._rebuild()

    def set_calibration(self, K1, K2, dist1, dist2):
        self._calib = tuple(common.to_device(a, self.device)
                            for a in (K1, K2, dist1, dist2))
        self._refine = None

    # -- data path ------------------------------------------------------
    def handle_stereo_pair(self, img_left, img_right) -> PoseMsg:
        """Image callback: match and estimate the pose of one frame."""
        if self._calib is None:
            raise RuntimeError("set_calibration() before streaming frames")
        # evStepStereoStable: once the stereo pose is stable, evaluate it
        # only every n-th frame and republish the held pose in between
        # (0 = every frame)
        ev_step = int(self._node.get("ev_step_stable", 0) or 0)
        if (
            self._node.get("stereo_ref")
            and ev_step > 0
            and self._refine is not None
            and self._refine.pose_is_stable
            and self._last_msg is not None
            and (self._frame_idx - self._last_eval_idx) < ev_step
        ):
            self._frame_idx += 1
            if self._on_pose is not None:
                self._on_pose(self._last_msg)
            return self._last_msg

        K1, K2, d1, d2 = self._calib
        i1 = common.to_device(img_left, self.device)
        i2 = common.to_device(img_right, self.device)
        corr = pipeline.get_correspondences(i1, i2, self._det, self._desc,
                                            self._match)
        frame = self._frame_idx
        self._frame_idx += 1
        self._last_eval_idx = self._frame_idx

        if self._node.get("stereo_ref"):
            if self._refine is None:
                kiba = bool(self._node.get("kneip_instead_ba", False))
                sr_cfg = StereoRefineConfig(pose=self._pose,
                                            kneip_instead_ba=kiba,
                                            kneip_instead_ba_pool=kiba)
                self._refine = StereoRefine(
                    K1, K2, d1, d2, cfg=sr_cfg, device=self.device,
                    streams=common.stereo_refine_streams(sr_cfg))
            st = self._refine.add_new_correspondences(
                corr.pts1, corr.pts2, corr.mask, corr.quality)
            use_ml = self._node.get("use_most_likely", False)
            msg = PoseMsg(
                R=np.asarray(st.R_most_likely if use_ml else st.R,
                             np.float64),
                t=np.asarray(st.t_most_likely if use_ml else st.t,
                             np.float64),
                n_inliers=int(st.pool_size),
                inlier_ratio=float(st.inlier_ratio),
                pose_is_stable=bool(st.pose_is_stable),
                R_most_likely=np.asarray(st.R_most_likely, np.float64),
                t_most_likely=np.asarray(st.t_most_likely, np.float64),
                most_likely_stable=bool(st.most_likely_pose_stable),
            )
        else:
            streams = common.frame_streams(frame, self._pose)
            res = pipeline.estimate_pose(
                corr.pts1, corr.pts2, corr.mask, corr.quality, K1, K2, d1,
                d2, self._pose, generator=self._generator,
                **{k: common.to_device(v, self.device)
                   for k, v in streams.items()})
            R, t, n_inl, ratio = common.to_host(res.R, res.t, res.n_inliers,
                                                res.inlier_ratio)
            msg = PoseMsg(R=R.astype(np.float64), t=t.astype(np.float64),
                          n_inliers=int(n_inl), inlier_ratio=float(ratio))
        self._last_msg = msg
        if self._on_pose is not None:
            self._on_pose(msg)
        return msg

    # -- optional ROS transport -----------------------------------------
    def spin(self, left_topic="/stereo/left/image_raw",
             right_topic="/stereo/right/image_raw"):
        """Subscribe to the image topics and stream (requires rospy)."""
        try:
            import message_filters
            import rospy
            from sensor_msgs.msg import Image
        except ImportError as e:  # the transport is optional by design
            raise RuntimeError(
                "rospy not available — drive handle_stereo_pair() directly"
            ) from e

        rospy.init_node("matchinglib_poselib_torch")

        def _to_gray(msg: Image) -> np.ndarray:
            buf = np.frombuffer(msg.data, np.uint8)
            img = buf.reshape(msg.height, msg.step)[:, : msg.width]
            return img.astype(np.float32) / 255.0

        def cb(lmsg, rmsg):
            self.handle_stereo_pair(_to_gray(lmsg), _to_gray(rmsg))

        subs = [
            message_filters.Subscriber(left_topic, Image),
            message_filters.Subscriber(right_topic, Image),
        ]
        message_filters.TimeSynchronizer(subs, queue_size=4).registerCallback(
            cb)
        rospy.spin()
