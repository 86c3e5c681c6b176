"""Shared helpers of the PyTorch-port parity tests (no tests of its own).

The parity tests feed the same numpy inputs, made from a seed, to a JAX
function of ``matchinglib_poselib_tpu`` and to its counterpart in
``matchinglib_poselib_torch``, and compare the outputs as numpy arrays.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from matchinglib_poselib_torch.ops.robust import sample_shapes

# xdist runs several workers per host: keep each worker's torch pool small
torch.set_num_threads(2)


def t(x, dtype=None):
    """numpy / JAX array -> CPU torch tensor (float32 unless given)."""
    a = np.asarray(x)
    if dtype is None and a.dtype == np.float64:
        a = a.astype(np.float32)
    out = torch.from_numpy(np.array(a, copy=True, order="C"))
    return out if dtype is None else out.to(dtype)


def j(x, dtype=jnp.float32):
    """numpy array -> JAX array."""
    return jnp.asarray(np.asarray(x), dtype)


def n(x):
    """torch tensor / JAX array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def words_u32_to_i32(d):
    """JAX (N, W) uint32 descriptor words -> the port's int32 bit patterns."""
    return torch.from_numpy(np.asarray(d, np.uint32).view(np.int32).copy())


def jax_uniforms(key, batches: int, B: int, k: int):
    """The uniforms the JAX ``ransac`` draws for batches 0..batches-1:
    ``uniform(fold_in(key, i), (B, k))``, stacked -> (batches, B, k)."""
    return torch.from_numpy(np.stack([
        np.asarray(jax.random.uniform(jax.random.fold_in(key, i), (B, k)))
        for i in range(batches)
    ]))


def jax_degen_uniforms(key, B: int):
    """Uniforms of the degeneracy check's single homography batch: the
    JAX package runs it under fold_in(key, 777), batch 0."""
    kd = jax.random.fold_in(key, 777)
    return jax_uniforms(kd, 1, min(B, 64), 4)


def jax_autoth_uniforms(key, rounds: int, batches: int, B: int, k: int):
    """AutoTh's streams as ``estimate_essential_autoth`` draws them: round
    r samples under the r-th ``split`` of the key, the degeneracy check
    under ``fold_in(key_left, 777)``. -> ((rounds, batches, B, k),
    (1, min(B, 64), 4))."""
    rounds_u = []
    for _ in range(rounds):
        key, sub = jax.random.split(key)
        rounds_u.append(jax_uniforms(sub, batches, B, k))
    return torch.stack(rounds_u), jax_degen_uniforms(key, B)


def jax_plane_uniforms(key, planes: int, batches: int, B: int):
    """Plane peeling's streams (``estimate_multiple_homographies``): plane
    r samples under the r-th ``split`` of the key. -> (planes, batches,
    B, 4)."""
    out = []
    for _ in range(planes):
        key, sub = jax.random.split(key)
        out.append(jax_uniforms(sub, batches, B, 4))
    return torch.stack(out)


def jax_halign_uniforms(key, planes: int, batches: int, B: int, k: int):
    """``estimate_pose``'s Halign streams: ``key, key_fb = split(key)``;
    the planes under ``key``, the robust-E fallback under ``key_fb``.
    -> (plane_uniforms, fallback uniforms (batches, B, k))."""
    key, key_fb = jax.random.split(key)
    return (jax_plane_uniforms(key, planes, batches, B),
            jax_uniforms(key_fb, batches, B, k))


def jax_stereo_refine_streams(seed, cfg, key=None):
    """The port's ``StereoRefine(streams=...)`` callable that replays the
    JAX ``StereoRefine``'s samples: each robust call takes the next
    ``key, sub = split(key)`` (``_next_key``, from ``PRNGKey(seed)`` or
    `key`, e.g. a checkpoint's ``prng_key``); ``_pose_from_set`` hands
    ``sub`` to ``estimate_essential_robust``, whose batch i samples under
    ``fold_in(sub, i)`` and whose degeneracy check under ``fold_in(sub,
    777)``. -> callable returning ((max_batches, B, k), (1, min(B, 64),
    4)); `cfg` is either package's StereoRefineConfig."""
    (nb, B, k), _ = sample_shapes(cfg.pose.robust)
    state = {"key": jax.random.PRNGKey(seed) if key is None
             else jnp.asarray(key, jnp.uint32)}

    def streams():
        state["key"], sub = jax.random.split(state["key"])
        return jax_uniforms(sub, nb, B, k), jax_degen_uniforms(sub, B)

    return streams


def jax_cli_frame_streams(i, pose_cfg):
    """The samples the JAX CLIs draw for frame i (``fold_in(PRNGKey(0),
    i)``), as the port's ``apps.common.frame_streams`` returns them."""
    (nb, B, k), _ = sample_shapes(pose_cfg.robust)
    key = jax.random.fold_in(jax.random.PRNGKey(0), i)
    return dict(uniforms=jax_uniforms(key, nb, B, k),
                degen_uniforms=jax_degen_uniforms(key, B))


def jax_pair_streams(key, P, robust):
    """A batch's streams as the JAX package's ``run_batch`` draws them:
    pair i's from the i-th key of split(key, P), stacked -> ((P,
    max_batches, B, k), (P, 1, min(B, 64), 4))."""
    (nb, B, k), _ = sample_shapes(robust)
    keys = jax.random.split(key, P)
    return (torch.stack([jax_uniforms(kk, nb, B, k) for kk in keys]),
            torch.stack([jax_degen_uniforms(kk, B) for kk in keys]))


def jax_pose_streams(key, cfg):
    """``estimate_pose``'s streams for one JAX key under a PoseConfig of
    either package, as the JAX ``estimate_pose`` samples them: Halign's
    planes and its fallback's ``key_fb`` (``jax_halign_uniforms``),
    AutoTh's rounds and degeneracy stream (``jax_autoth_uniforms``), or
    the default branch's E and degeneracy streams. -> dict of the port's
    stream arguments."""
    (nb, B, k), _ = sample_shapes(cfg.robust)
    if cfg.use_halign:
        planes, fb = jax_halign_uniforms(key, cfg.halign.max_planes, nb, B,
                                         k)
        return dict(plane_uniforms=planes, uniforms=fb)
    if cfg.auto_th:
        u, d = jax_autoth_uniforms(key, 3, nb, B, k)
        return dict(uniforms=u, degen_uniforms=d)
    return dict(uniforms=jax_uniforms(key, nb, B, k),
                degen_uniforms=jax_degen_uniforms(key, B))


def jax_pair_pose_streams(key, P, cfg):
    """A batch's streams for any PoseConfig branch as the JAX package's
    ``run_batch`` draws them: pair i's (``jax_pose_streams``) from the
    i-th key of split(key, P), stacked on a leading P."""
    per = [jax_pose_streams(kk, cfg) for kk in jax.random.split(key, P)]
    return {name: torch.stack([p[name] for p in per]) for name in per[0]}


# the robust engine's counters of a PoseResult
COUNTERS = ("n_models_generated", "n_models_rejected", "n_points_verified",
            "n_lo_refinements")


def assert_pair_equal(corr, pose, c, p, i):
    """Pair i of a batch's Correspondences and PoseResult against a single
    pair's (c, p): every correspondence and keypoint field exact, the pose
    as ``assert_pose_equal``."""
    for name in ("pts1", "pts2", "mask", "quality", "distance"):
        assert torch.equal(getattr(corr, name)[i], getattr(c, name)), name
    for side in ("kps1", "kps2"):
        for a, b in zip(getattr(corr, side), getattr(c, side)):
            assert torch.equal(a[i], b), side
    assert_pose_equal(pose, p, i)


def assert_pose_equal(pose, p, i):
    """Pair i of a batched PoseResult against a single pair's: masks,
    flags and counters exact, R, t and E within 1e-5."""
    for name in ("inlier_mask", "valid3d", "is_degenerate",
                 "halign_error_code", *COUNTERS):
        assert torch.equal(getattr(pose, name)[i], getattr(p, name)), name
    for name in ("R", "t", "E"):
        diff = (getattr(pose, name)[i] - getattr(p, name)).abs().max()
        assert float(diff) <= 1e-5, (name, float(diff))


def rot_angle_deg(Ra, Rb):
    """Angle of Ra^T Rb in degrees (float64)."""
    dR = np.asarray(Ra, np.float64).T @ np.asarray(Rb, np.float64)
    c = np.clip((np.trace(dR) - 1.0) / 2.0, -1.0, 1.0)
    return float(np.degrees(np.arccos(c)))


def rot_chordal_deg(Ra, Rb):
    """Angle of Ra^T Rb in degrees from the chordal distance |Ra - Rb|_F =
    2 sqrt(2) sin(angle / 2): unlike the trace form it does not saturate
    for f32 rotations orthonormal only to ~1e-7 (the trace form's floor is
    ~0.05-0.1 deg there)."""
    d = np.linalg.norm(np.asarray(Ra, np.float64) - np.asarray(Rb, np.float64))
    return float(np.degrees(2.0 * np.arcsin(min(1.0, d / (2.0 * np.sqrt(2.0))))))


def dir_angle_deg(a, b):
    """Angle between two direction vectors in degrees (float64)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    c = np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b))
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def textured_image(rng, h=240, w=320):
    """Smooth random texture with corners (as tests/test_features.py)."""
    img = rng.normal(size=(h // 4, w // 4)).astype(np.float32)
    img = np.kron(img, np.ones((4, 4), np.float32))
    for _ in range(2):
        img = 0.25 * (
            np.roll(img, 1, 0) + np.roll(img, -1, 0)
            + np.roll(img, 1, 1) + np.roll(img, -1, 1)
        )
    return (img - img.min()) / (img.max() - img.min())


def align_slots(jxy, jmask, txy, tmask, tol=1e-4):
    """For every JAX keypoint slot, the port slot holding the keypoint at
    the same position (max-norm distance <= tol), or -1 (also for masked
    JAX slots). Scale-space detectors can find an extremum on an f32 near
    tie on one side only, which shifts every later slot; aligning by
    position compares the rest slot for slot again."""
    jxy = np.asarray(jxy, np.float64)
    txy = np.asarray(txy, np.float64)
    d = np.abs(jxy[:, None, :] - txy[None, :, :]).max(-1)
    d[~np.asarray(jmask, bool)] = np.inf
    d[:, ~np.asarray(tmask, bool)] = np.inf
    best = d.argmin(1)
    ok = d[np.arange(len(best)), best] <= tol
    return np.where(ok, best, -1)


def aligned_fraction(perm, jmask, tmask):
    """Share of the keypoints valid on either side that the other side
    holds at the same position, and the number that it misses."""
    jmask, tmask = np.asarray(jmask, bool), np.asarray(tmask, bool)
    both = int((perm >= 0).sum())
    union = int(jmask.sum() + tmask.sum()) - both
    return both / max(union, 1), union - both


# ---------------------------------------------------------------------------
# the pose branches with a pair axis (test_torch_batch_*.py)
# ---------------------------------------------------------------------------

# bars of a pair against the JAX package's vmap: inlier slots, rotation
# (chordal) and translation direction in deg; the Kneip polish's energy is
# flat in f32 at its minimum (test_torch_eigensolver.py)
BRANCH_AGREE = 0.995
BRANCH_DEG = (0.01, 0.05)
KNEIP_DEG = (0.1, 0.25)


def pose_pairs(specs):
    """Pixel correspondences of len(specs) synthetic pairs, each
    ``test_pose_branches._pixel_correspondences(**spec)`` (K, no
    distortion), stacked: (R (P, 3, 3), t (P, 3), pts1, pts2, mask,
    quality) as numpy arrays."""
    from test_pose_branches import _pixel_correspondences

    out = [_pixel_correspondences(**s) for s in specs]
    return tuple(np.stack([o[k] for o in out]) for k in range(6))


def jax_vmap_pose(cfg, K, dist, pts1, pts2, mask, quality, key):
    """``jax.vmap`` of the JAX package's ``estimate_pose`` over the pairs,
    pair i under the i-th key of split(key, P), as its ``run_batch``
    calls it."""
    from matchinglib_poselib_tpu.models import pipeline as jp

    Kj, dj = jnp.asarray(K), jnp.asarray(dist)
    keys = jax.random.split(key, mask.shape[0])
    return jax.vmap(lambda a, b, c, d, kk: jp.estimate_pose(
        a, b, c, d, Kj, Kj, dj, dj, cfg, kk))(
            *(jnp.asarray(x) for x in (pts1, pts2, mask, quality)), keys)


def check_pose_vs_jax(tpose, jpose, deg=BRANCH_DEG):
    """Every pair of a batched PoseResult against the JAX package's: inlier
    masks on >= BRANCH_AGREE of the slots, R and t within `deg`, the
    Halign error code and the degeneracy flag equal."""
    for i in range(tpose.R.shape[0]):
        agree = (n(tpose.inlier_mask[i])
                 == np.asarray(jpose.inlier_mask[i])).mean()
        assert agree >= BRANCH_AGREE, (i, agree)
        assert rot_chordal_deg(np.asarray(jpose.R[i]),
                               n(tpose.R[i])) < deg[0], i
        assert dir_angle_deg(np.asarray(jpose.t[i]), n(tpose.t[i])) < deg[1]
        assert int(tpose.halign_error_code[i]) == int(
            jpose.halign_error_code[i]), i
        assert bool(tpose.is_degenerate[i]) == bool(jpose.is_degenerate[i])


def check_batch_vs_singles(estimate, pts, cfg, streams):
    """The batched ``estimate_pose`` (``estimate(pts..., cfg, **kw)``)
    against one call per pair, field by field (``assert_pose_equal``),
    with explicit streams (``streams``: dict) or with one seeded generator
    shared by the single calls (``streams`` None); each run of each
    data-dependent loop reads the host as often as its slowest pair
    alone. Returns the batched PoseResult."""
    from matchinglib_poselib_torch.utils.profiling import (
        HostSyncs, loop_iterations,
    )

    P = pts[2].shape[0]
    if streams is None:
        kw = dict(generator=torch.Generator().manual_seed(5))
        gen = torch.Generator().manual_seed(5)
        per = [dict(generator=gen) for _ in range(P)]
    else:
        kw = streams
        per = [{k: v[i] for k, v in streams.items()} for i in range(P)]
    with HostSyncs.traced() as log:
        pose = estimate(*pts, cfg, **kw)
    alone = []
    for i in range(P):
        with HostSyncs.traced() as log_i:
            p = estimate(*(x[i] for x in pts), cfg, **per[i])
        assert_pose_equal(pose, p, i)
        alone.append(loop_iterations(log_i))
    runs = {k for a in alone for k in a}
    assert loop_iterations(log) == {k: max(a.get(k, 0) for a in alone)
                                    for k in runs}
    return pose


def exhaustive_sharded_match(q, db, vq, vdb, shards: int, binary=True,
                             ratio=None, ratio_test=True, cross_check=True):
    """``parallel.matching.sharded_match`` over `shards` equal contiguous
    blocks of (db, vdb), in one process and with the exhaustive reverse:
    every block row's best valid query (the JAX package's argmin over its
    shard's distance columns), read at the merged matches' rows. The
    forward search, the merge and the tie rules are sharded_match's; the
    plain K2a / K2b of CPU tensors. Returns {field: tensor}."""
    from matchinglib_poselib_torch.config import LOWE_RATIO
    from matchinglib_poselib_torch.ops.kernels import knn2

    big = 1e9
    ratio = LOWE_RATIO if ratio is None else ratio
    search = knn2.knn2 if binary else knn2.knn2_l2
    if not binary:
        q, db = q.to(torch.float32), db.to(torch.float32)
    vq, vdb = vq.to(torch.bool), vdb.to(torch.bool)
    rows = db.shape[0] // shards
    d1s, d2s, gis, cols = [], [], [], []
    for s in range(shards):
        blk = slice(s * rows, (s + 1) * rows)
        d1, d2, idx = search(q, db[blk].contiguous(), vdb[blk].contiguous())
        d1s.append(torch.where(vq, d1, big))
        d2s.append(torch.where(vq, d2, big))
        gis.append(torch.where(vq, idx.clamp(min=0), 0) + s * rows)
        cols.append(search(db[blk].contiguous(), q, vq)[2].clamp(min=0))
    cand_d = torch.cat([torch.stack(d1s), torch.stack(d2s)])
    ig = torch.stack(gis).to(torch.int32)
    cand_i = torch.cat([ig, torch.full_like(ig, -1)])
    vals, order = torch.sort(cand_d, dim=0, stable=True)
    best_i = torch.gather(cand_i, 0, order[:1])[0]
    keep = vq & (vals[0] < big * 0.5)
    if ratio_test:
        keep = keep & (vals[0] < ratio * vals[1])
    if cross_check:
        keep = keep & (torch.cat(cols)[best_i.long()]
                       == torch.arange(q.shape[0]))
    return {"idx": best_i, "distance": vals[0], "second_distance": vals[1],
            "mask": keep}
