"""Correspondence pool: fixed-capacity SoA tensors with masked ops (port
of ``ops/pool.py``).

The streaming framework's pool of correspondences (CoordinateProps,
stereo_pose_types.h:34-62) is one structure of equal-length tensors with
a validity mask, kept on the device across frames:

- spatial dedup of new correspondences against the nearest valid pool
  point (filterNewCorrespondences, stereo_pose_refinement.cpp:2107, with
  compareCorrespondences' decision rule :2450) as a dense distance matrix;
- quality weights (computeCorrespondenceWeight :2514) with the far-point
  penalty;
- insertion and capacity eviction (checkPoolSize :2550) as one stable
  top-k over pool and new rows;
- the post-acceptance update (Sampson history, triangulated point,
  far-point flag, age, weight), outlier eviction and pool statistics.

Layout and tie rules are the JAX package's, slot for slot: the nearest
pool point is the lowest index among equal distances, the eviction keeps
the lowest index among equal scores, and where two new rows share their
nearest pool point the highest row index decides that slot's validity.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from matchinglib_poselib_torch.ops import geometry as geo

class Pool(NamedTuple):
    """SoA correspondence pool (capacity P, masked)."""

    pt1: torch.Tensor  # (P, 2) pixel coords, left
    pt2: torch.Tensor  # (P, 2) pixel coords, right
    x1: torch.Tensor  # (P, 2) normalized undistorted cam coords, left
    x2: torch.Tensor  # (P, 2) normalized undistorted cam coords, right
    desc_dist: torch.Tensor  # (P,) descriptor distance of the match
    response: torch.Tensor  # (P,) combined keypoint response
    sampson: torch.Tensor  # (P,) last squared Sampson error
    sampson_prev: torch.Tensor  # (P,) previous entry of the error history
    sampson_sum: torch.Tensor  # (P,) running sum of the error history
    sampson_count: torch.Tensor  # (P,) int32 length of the error history
    q: torch.Tensor  # (P, 3) triangulated 3D point (camera-1 frame)
    q_valid: torch.Tensor  # (P,) bool: q has been triangulated
    q_too_far: torch.Tensor  # (P,) bool: z beyond maxDist3DPtsZ (or behind)
    n_found: torch.Tensor  # (P,) int32 nrFound re-detection counter
    age: torch.Tensor  # (P,) int32 estimation iterations alive
    weight: torch.Tensor  # (P,) eviction/quality weight (higher = better)
    valid: torch.Tensor  # (P,) bool

    @property
    def capacity(self) -> int:
        return self.valid.shape[0]

    @property
    def n_valid(self) -> torch.Tensor:
        return torch.sum(self.valid.to(torch.int32))

    @property
    def mean_sampson(self) -> torch.Tensor:
        """meanSampsonError (stereo_pose_types.h:61)."""
        return self.sampson_sum / torch.clamp(
            self.sampson_count.to(self.sampson_sum.dtype), min=1.0)


def empty_pool(capacity: int, device: torch.device | str = "cpu",
               dtype=torch.float32) -> Pool:
    def z(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    return Pool(
        pt1=z(capacity, 2), pt2=z(capacity, 2), x1=z(capacity, 2),
        x2=z(capacity, 2), desc_dist=z(capacity), response=z(capacity),
        sampson=torch.full((capacity,), 1e9, dtype=dtype, device=device),
        sampson_prev=torch.full((capacity,), 1e9, dtype=dtype,
                                device=device),
        sampson_sum=z(capacity), sampson_count=z(capacity, dt=torch.int32),
        q=z(capacity, 3), q_valid=z(capacity, dt=torch.bool),
        q_too_far=z(capacity, dt=torch.bool),
        n_found=z(capacity, dt=torch.int32), age=z(capacity, dt=torch.int32),
        weight=z(capacity), valid=z(capacity, dt=torch.bool),
    )


def correspondence_weight(
    sampson_sq: torch.Tensor,
    desc_dist: torch.Tensor,
    response: torch.Tensor,
    th_sq,
    max_desc_dist: float = 256.0,
    q_too_far: torch.Tensor | None = None,
    q_z: torch.Tensor | None = None,
    max_dist_z=50.0,
) -> torch.Tensor:
    """Quality weight per correspondence (higher = better):
    0.3 (1 - err / th^2) + 0.5 (1 - descrDist / max) + 0.2 response, times
    the far-point penalty 0.5 + 0.9 maxDist3DPtsZ / (2 z) (0.25 behind
    the camera) where q_too_far is set (:2514-2538)."""
    th_sq = torch.as_tensor(th_sq, dtype=sampson_sq.dtype,
                            device=sampson_sq.device)
    w_err = 1.0 - sampson_sq / torch.clamp(th_sq, min=1e-12)
    w_desc = 1.0 - torch.clamp(desc_dist / max_desc_dist, 0.0, 1.0)
    w_resp = torch.clamp(response, 0.0, 1.0)
    w = 0.3 * w_err + 0.5 * w_desc + 0.2 * w_resp
    if q_too_far is not None and q_z is not None:
        z_pen = torch.where(
            q_z > 0, 0.5 + 0.9 * max_dist_z / torch.clamp(2.0 * q_z, min=1e-9),
            0.25)
        w = torch.where(q_too_far, w * z_pen, w)
    return w


def _nearest_valid(pool: Pool, new_pt1: torch.Tensor):
    """(index, squared distance) of each new point's nearest valid pool
    point in the left image; the lowest index among equal distances, index
    0 and inf when the pool is empty."""
    dx = new_pt1[:, 0:1] - pool.pt1[:, 0][None]
    dy = new_pt1[:, 1:2] - pool.pt1[:, 1][None]
    d2 = torch.where(pool.valid[None], dx * dx + dy * dy, torch.inf)
    near = torch.argmin(d2, dim=1)
    return near, torch.gather(d2, 1, near[:, None])[:, 0]


def filter_new_vs_pool(
    pool: Pool,
    new_pt1: torch.Tensor,  # (K, 2) pixel coords (left image)
    new_pt2: torch.Tensor,  # (K, 2) pixel coords (right image)
    new_weight: torch.Tensor,  # (K,)
    new_valid: torch.Tensor,  # (K,) bool
    min_dist: float,
):
    """Spatial dedup of new correspondences against the nearest valid pool
    point (filterNewCorrespondences :2107-2207, compareCorrespondences
    :2450-2497):

    - coincident pair (both endpoints < 0.1 px): drop the new one and bump
      the pool entry's nrFound;
    - same-point pair (< sqrt(2) px at both endpoints): keep the clearly
      better one (5% dead band, 20% decisive band on the relative weight,
      old-age > 15 and increasing-error preferences for the new one);
    - merely nearby (within min_dist): the new one survives only if
      decisively better, and then evicts the old one.

    Where several new rows share a nearest pool point, the highest row
    index decides whether that slot is killed (the JAX package's scatter
    on its CPU path: the last writer wins), on every device.

    Returns (new_valid_out, pool_valid_out, n_found_out).
    """
    K = new_pt1.shape[0]
    new_valid = new_valid.to(torch.bool)
    near, near_d2 = _nearest_valid(pool, new_pt1)
    within = (near_d2 < float(min_dist) * float(min_dist)) & new_valid

    d2_pt2 = torch.sum((new_pt2 - pool.pt2[near]) ** 2, dim=-1)
    same_point = within & (near_d2 < 2.0) & (d2_pt2 < 2.0)
    coincident = same_point & (near_d2 < 0.01) & (d2_pt2 < 0.01)

    old_w = pool.weight[near]
    rel_new = (new_weight - old_w) / torch.clamp(new_weight, min=1e-12)
    rel_old = (old_w - new_weight) / torch.clamp(old_w, min=1e-12)
    old_is_better = old_w >= new_weight
    decisive_old = old_is_better & ((rel_old >= 0.05) | (rel_old > 0.2))
    dead_band = (~old_is_better) & (rel_new < 0.05)
    decisive_new = (~old_is_better) & (rel_new > 0.2)
    old_age_pref = pool.age[near] > 15
    err_increasing = pool.sampson[near] > pool.sampson_prev[near]
    tie = ~(decisive_old | dead_band | decisive_new)
    new_better = decisive_new | (tie & (old_age_pref | err_increasing))

    drop_new = within & (coincident | ~new_better)
    kill_old = (same_point & new_better & ~coincident) | (
        within & ~same_point & decisive_new)

    new_valid_out = new_valid & ~drop_new
    # the last writer of each slot: the highest row index pointing to it
    rows = torch.arange(K, device=near.device)
    last = torch.full((pool.capacity,), -1, dtype=torch.int64,
                      device=near.device).scatter_reduce(
        0, near, rows, reduce="amax", include_self=True)
    killed = (last >= 0) & kill_old[torch.clamp(last, min=0)]
    pool_valid_out = pool.valid & ~killed
    n_found_out = pool.n_found.index_add(0, near, coincident.to(torch.int32))
    return new_valid_out, pool_valid_out, n_found_out


def insert_and_evict(
    pool: Pool,
    new_pt1, new_pt2, new_x1, new_x2,
    new_desc_dist, new_response, new_sampson,
    new_weight, new_valid,
) -> Pool:
    """Insert K new correspondences, evicting the lowest-weight entries
    (addCorrespondencesToPool :1150-1220 + checkPoolSize :2550): pool and
    new rows concatenated, the capacity-P best by (valid, weight) kept by
    one stable top-k (ties to the lowest index; invalid rows score -inf,
    so free slots fill before anything is evicted). New rows start their
    Sampson history with the entry error and nrFound = 1."""
    P = pool.capacity
    K = new_weight.shape[0]
    dev, dt = new_weight.device, new_sampson.dtype
    valid = torch.cat([pool.valid, new_valid.to(torch.bool)])
    weight = torch.cat([pool.weight, new_weight])
    score = torch.where(valid, weight, -torch.inf)
    _, keep = geo.topk_stable(score, P)
    zi = torch.zeros((K,), dtype=torch.int32, device=dev)
    zb = torch.zeros((K,), dtype=torch.bool, device=dev)

    def take(a, b):
        return torch.cat([a, b])[keep]

    return Pool(
        pt1=take(pool.pt1, new_pt1),
        pt2=take(pool.pt2, new_pt2),
        x1=take(pool.x1, new_x1),
        x2=take(pool.x2, new_x2),
        desc_dist=take(pool.desc_dist, new_desc_dist),
        response=take(pool.response, new_response),
        sampson=take(pool.sampson, new_sampson),
        sampson_prev=take(pool.sampson_prev,
                          torch.full((K,), 1e9, dtype=dt, device=dev)),
        sampson_sum=take(pool.sampson_sum, new_sampson),
        sampson_count=take(pool.sampson_count, zi + 1),
        q=take(pool.q, torch.zeros((K, 3), dtype=dt, device=dev)),
        q_valid=take(pool.q_valid, zb),
        q_too_far=take(pool.q_too_far, zb),
        n_found=take(pool.n_found, zi + 1),
        age=take(pool.age, zi),
        weight=weight[keep],
        valid=valid[keep],
    )


def update_pool_state(pool: Pool, E, R, t, th_sq, max_dist_z) -> Pool:
    """Post-acceptance update against the new pose (:905-940): push the
    Sampson error onto the history, re-triangulate q with the far flag
    (z > maxDist3DPtsZ or behind a camera), bump the age, recompute the
    weight with the far-point penalty."""
    err = geo.sampson_error(E, pool.x1, pool.x2)
    X = geo.triangulate_linear(R, t, pool.x1, pool.x2)
    z2 = (X @ R.T + t)[:, 2]
    in_front = (X[:, 2] > 0) & (z2 > 0)
    too_far = (X[:, 2] > max_dist_z) | ~in_front
    w = correspondence_weight(
        err, pool.desc_dist, pool.response, th_sq,
        q_too_far=too_far, q_z=X[:, 2], max_dist_z=max_dist_z)
    return pool._replace(
        sampson=err,
        sampson_prev=pool.sampson,
        sampson_sum=pool.sampson_sum + err,
        sampson_count=pool.sampson_count + 1,
        q=X,
        q_valid=pool.valid,
        q_too_far=too_far & pool.valid,
        age=pool.age + pool.valid.to(torch.int32),
        weight=torch.where(pool.valid, w, 0.0),
    )


def evict_outliers(pool: Pool, E, th_sq) -> Pool:
    """Drop pool entries inconsistent with the (refined) pose
    (:861-908)."""
    err = geo.sampson_error(E, pool.x1, pool.x2)
    return pool._replace(valid=pool.valid & (err < th_sq))


def far_point_ratio(pool: Pool) -> torch.Tensor:
    """ratio3DPtsFar (:3206-3210): the share of triangulated valid pool
    points flagged too far."""
    n_q = torch.sum((pool.q_valid & pool.valid).to(torch.int32))
    n_far = torch.sum((pool.q_too_far & pool.valid).to(torch.int32))
    return n_far.to(torch.float32) / torch.clamp(n_q.to(torch.float32),
                                                 min=1.0)


def pool_inlier_stats(pool: Pool, E, th_sq):
    """(n_inliers, n_valid, (median, mean, std, MAD) of the square-root
    Sampson error on the inliers)."""
    err = geo.sampson_error(E, pool.x1, pool.x2)
    inl = (err < th_sq) & pool.valid
    n_inl = torch.sum(inl.to(torch.int32))
    stats = geo.masked_stats(torch.sqrt(torch.clamp(err, min=0.0)), inl)
    return n_inl, pool.n_valid, stats
