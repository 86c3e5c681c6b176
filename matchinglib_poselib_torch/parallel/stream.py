"""Frame-window sharding of the stereo stream (port of
``parallel/stream.py``).

The stream is cut into contiguous frame windows, one per ``pairs`` rank;
per-frame poses are estimated inside each window, and the windows'
posteriors are merged by one all-reduce into a stream-level most-likely
pose: the weighted quaternion mean (Markley's method: the largest
eigenvector of the summed 4x4 outer products) and the weighted mean
translation direction, the distributed form of the reference's
pose-history ranking (getNearToMeanPose, stereo_pose_refinement.cpp:2817).
One all-reduce of 4 x 4 + 3 + 1 scalars per call.
"""

from __future__ import annotations

import torch

from matchinglib_poselib_torch.ops import geometry as geo
from matchinglib_poselib_torch.parallel import mesh as pmesh


def frame_window_block(mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's contiguous window of a (F, ...) frame-stream array:
    frames [i F / n, (i + 1) F / n) for the i-th of n ``pairs`` ranks
    (the JAX package's ``frame_window_sharding``)."""
    return pmesh.block(mesh, x, pmesh.PAIRS_AXIS)


def t_frames_normalize(t: torch.Tensor) -> torch.Tensor:
    return t / torch.clamp(torch.linalg.norm(t, dim=-1, keepdim=True),
                           min=1e-12)


def windowed_pose_consensus(mesh, R_frames: torch.Tensor,
                            t_frames: torch.Tensor, weights: torch.Tensor):
    """Stream-level most-likely pose from this rank's frame window.

    R_frames (f, 3, 3), t_frames (f, 3), weights (f,) (e.g. inlier counts;
    <= 0 drops a frame): this rank's window (``frame_window_block``).
    Returns (R_ml (3, 3), t_ml (3,), total weight), the same on every
    rank."""
    q = geo.quat_from_rot(R_frames)  # (f, 4)
    # the q / -q double cover, resolved inside the window against its
    # first frame's sign
    sign = torch.where(torch.sum(q * q[0:1], dim=-1, keepdim=True) < 0,
                       -1.0, 1.0)
    q = q * sign
    wpos = torch.clamp(weights, min=0.0)
    M = torch.einsum("f,fi,fj->ij", wpos, q, q)
    ts = torch.einsum("f,fi->i", wpos, t_frames_normalize(t_frames))
    wsum = torch.sum(wpos)
    summed = pmesh.sum_axis(
        mesh, torch.cat([M.reshape(16), ts, wsum[None]]), pmesh.PAIRS_AXIS)
    M, ts, wsum = summed[:16].reshape(4, 4), summed[16:19], summed[19]
    # largest eigenvector of the symmetric 4x4 -> mean quaternion
    _, evecs = torch.linalg.eigh(M)
    R_ml = geo.rot_from_quat(evecs[:, -1])
    t_ml = ts / torch.clamp(torch.linalg.norm(ts), min=1e-12)
    return R_ml, t_ml, wsum
