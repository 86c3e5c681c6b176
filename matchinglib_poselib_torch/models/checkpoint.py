"""Checkpoint / resume of the ``StereoRefine`` streaming state (port of
``models/checkpoint.py``).

The JAX package's ``.npz`` format, version 2, key for key: the pool's SoA
arrays as ``pool_<field>``, the pose, the pose and ratio history, the
state-machine counters as a JSON blob (``scalars_json``), written to a
temporary file and published by an atomic rename. A checkpoint of either
package can be read by the port:

- the port stores its own sample state (the ``torch.Generator``'s) under
  ``torch_generator_state`` with its device type under
  ``torch_generator_device``, and restores it into a generator of that
  device type (another one keeps its seed); ``prng_key`` holds the raw
  form of ``PRNGKey(seed)`` so the JAX package can read the file too;
- a checkpoint written by the JAX package carries a JAX ``prng_key``,
  which has no torch counterpart: the port takes everything but it, and
  the caller's ``streams`` or seed supply the samples from there on.

Like the JAX format, a checkpoint holds neither the SPRT history nor the
last delta: a resumed stream starts its SPRT prior afresh.
"""

from __future__ import annotations

import json
import os
import pathlib
import tempfile

import numpy as np
import torch

from matchinglib_poselib_torch import convert
from matchinglib_poselib_torch.ops import pool as poolops

_FORMAT_VERSION = 2


def save_stereo_refine(sr, path: str | os.PathLike, seed: int = 0) -> None:
    """Serialize a StereoRefine's mutable state to ``path``. The
    calibration and config are constructor inputs and not stored; `seed`
    goes into ``prng_key`` as the JAX package's raw key of that seed."""
    path = pathlib.Path(path)
    pool_arrays = {f"pool_{name}": val.detach().cpu().numpy()
                   for name, val in sr.pool._asdict().items()}
    hist_R = (np.stack([h[0] for h in sr.pose_history]) if sr.pose_history
              else np.zeros((0, 3, 3)))
    hist_t = (np.stack([h[1] for h in sr.pose_history]) if sr.pose_history
              else np.zeros((0, 3)))
    scalars = {
        "format_version": _FORMAT_VERSION,
        "nr_estimation": int(sr.nr_estimation),
        "frame_idx": int(sr.frame_idx),
        "skip_count": int(sr.skip_count),
        "max_skip_pairs_new": int(sr.max_skip_pairs_new),
        "pose_is_stable": bool(sr.pose_is_stable),
        "most_likely_pose_stable": bool(sr.most_likely_pose_stable),
        "nr_since_robust": int(sr._nr_since_robust),
        "check_pool_robust_tmp": int(sr._check_pool_robust_tmp),
        "init_number_inliers": int(sr._init_number_inliers),
        "failed_refinements": int(sr._failed_refinements),
        "max_pool_size_reached": bool(sr.max_pool_size_reached),
        "nr_consec_stable": int(sr.nr_consec_stable),
        "stability_tries": int(sr._stability_tries),
        "most_likely_idxs": [int(i) for i in sr.most_likely_idxs[-100:]],
        "pose_ratings": [float(r) for r in sr.pose_ratings],
        "err_stat_history": [[float(m), float(s)]
                             for m, s in sr.err_stat_history[-100:]],
    }
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(
                f,
                scalars_json=np.frombuffer(json.dumps(scalars).encode(),
                                           dtype=np.uint8),
                R=np.asarray(sr.R), t=np.asarray(sr.t), E=np.asarray(sr.E),
                R_most_likely=np.asarray(sr.R_most_likely),
                t_most_likely=np.asarray(sr.t_most_likely),
                hist_R=hist_R, hist_t=hist_t,
                ratio_history=np.asarray(sr.ratio_history, np.float64),
                prng_key=np.array([0, seed & 0xFFFFFFFF], np.uint32),
                torch_generator_state=sr.generator.get_state().numpy(),
                torch_generator_device=np.array(sr.generator.device.type),
                **pool_arrays,
            )
        os.replace(tmp, path)  # atomic publish
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_stereo_refine(sr, path: str | os.PathLike) -> None:
    """Restore a checkpoint of either package into ``sr``, which must be
    constructed with the same config (a pool capacity mismatch raises)."""
    with np.load(pathlib.Path(path)) as z:
        scalars = json.loads(bytes(z["scalars_json"]).decode())
        if scalars.get("format_version") != _FORMAT_VERSION:
            raise ValueError(
                f"checkpoint format {scalars.get('format_version')} != "
                f"{_FORMAT_VERSION}")
        pool = convert.pool_from_numpy(
            {name: z[f"pool_{name}"] for name in poolops.Pool._fields},
            sr.device)
        if pool.capacity != sr.cfg.max_pool_correspondences:
            raise ValueError(
                f"pool capacity {pool.capacity} != configured "
                f"{sr.cfg.max_pool_correspondences}")
        sr.pool = pool
        sr._set_pose(z["E"], z["R"], z["t"])
        sr.R_most_likely = z["R_most_likely"]
        sr.t_most_likely = z["t_most_likely"]
        sr.pose_history = [(z["hist_R"][i], z["hist_t"][i])
                           for i in range(z["hist_R"].shape[0])]
        sr.ratio_history = [float(r) for r in z["ratio_history"]]
        if ("torch_generator_state" in z.files
                and str(z["torch_generator_device"])
                == sr.generator.device.type):
            sr.generator.set_state(
                torch.from_numpy(z["torch_generator_state"].copy()))
    sr.nr_estimation = scalars["nr_estimation"]
    sr.frame_idx = scalars["frame_idx"]
    sr.skip_count = scalars["skip_count"]
    sr.max_skip_pairs_new = scalars["max_skip_pairs_new"]
    sr.pose_is_stable = scalars["pose_is_stable"]
    sr.most_likely_pose_stable = scalars["most_likely_pose_stable"]
    sr._nr_since_robust = scalars["nr_since_robust"]
    sr._check_pool_robust_tmp = scalars["check_pool_robust_tmp"]
    sr._init_number_inliers = scalars["init_number_inliers"]
    sr._failed_refinements = scalars["failed_refinements"]
    sr.max_pool_size_reached = scalars["max_pool_size_reached"]
    sr.nr_consec_stable = scalars["nr_consec_stable"]
    sr._stability_tries = scalars["stability_tries"]
    sr.most_likely_idxs = [int(i) for i in scalars["most_likely_idxs"]]
    sr.pose_ratings = [float(r) for r in scalars["pose_ratings"]]
    sr.err_stat_history = [(float(m), float(sd))
                           for m, sd in scalars["err_stat_history"]]
