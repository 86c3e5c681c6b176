"""Distributed windowed bundle adjustment over point shards (port of
``parallel/ba.py``).

Each ``db`` rank owns a contiguous block of the 3D points and their
observations, computes its part of the camera Hessian blocks, the Schur
sums, the gradient and the cost, and ``ops.ba.bundle_adjust(...,
group=...)`` all-reduces them over the ``db`` group, so that the reduced
camera system, its solve and the camera update are the same on every
rank; the point updates stay with their block. Traffic per LM iteration
is O((C D)^2) scalars, whatever the number of points.
"""

from __future__ import annotations

import torch

from matchinglib_poselib_torch.ops import ba
from matchinglib_poselib_torch.parallel import mesh as pmesh


def bundle_adjust_sharded(
    mesh,
    obs: torch.Tensor,  # (P, C, 2), P divisible by the db size
    vis: torch.Tensor,  # (P, C)
    R: torch.Tensor,  # (C, 3, 3)
    t: torch.Tensor,  # (C, 3)
    K: torch.Tensor,  # (C, 3, 3)
    dist: torch.Tensor,  # (C, 5)
    X: torch.Tensor,  # (P, 3)
    free_cams: torch.Tensor,  # (C,)
    iterations: int = 20,
    robust: bool = True,
    huber_delta: float = 1.0,
    refine_intrinsics: bool = False,
) -> ba.BAResult:
    """``ops.ba.bundle_adjust`` with the points sharded over the ``db``
    axis: every rank passes the whole problem and solves its block of
    points. Returns a BAResult whose cameras are the same on every rank
    and whose ``points`` are the full (gathered) structure. ValueError
    when P does not divide the db size."""
    n_shards = pmesh.axis_size(mesh, pmesh.DB_AXIS)
    if obs.shape[0] % n_shards:
        raise ValueError(f"bundle_adjust_sharded: {obs.shape[0]} points do "
                         f"not divide the db axis of size {n_shards}")
    res = ba.bundle_adjust(
        pmesh.db_block(mesh, obs), pmesh.db_block(mesh, vis), R, t, K, dist,
        pmesh.db_block(mesh, X), free_cams, iterations=iterations,
        robust=robust, huber_delta=huber_delta,
        refine_intrinsics=refine_intrinsics,
        group=mesh.get_group(pmesh.DB_AXIS))
    return res._replace(
        points=pmesh.gather_axis(mesh, res.points, pmesh.DB_AXIS))
