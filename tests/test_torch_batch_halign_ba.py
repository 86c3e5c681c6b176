"""Halign and stereo BA of ``estimate_pose`` with a pair axis.

- Against the JAX package: the port's batched ``estimate_pose`` against
  ``jax.vmap`` of the JAX package's on 3 synthetic pairs
  (``test_torch_helpers.pose_pairs``, 64 x 4 hypotheses), pair i's streams
  from the i-th key of ``split(PRNGKey(11), 3)``
  (``jax_pair_pose_streams``): inlier masks on >= 99.5% of the slots, R
  within 0.01 deg (chordal) and t within 0.05 deg, the Halign code and the
  degeneracy flag equal (``check_pose_vs_jax``). Halign's batch mixes two
  planar pairs that keep Halign's pose (code 0) with a general scene,
  which takes the robust-E fallback (code -1). The batched two-view
  ``bundle_adjust`` (2 least-squares LM steps from a turned pose)
  against ``jax.vmap`` of the JAX package's: accepted steps equal per pair
  and not all the same (two pairs reject the second step that the third
  accepts), costs within 1e-3 relative, poses within 5e-3 deg, each pair
  bit-equal to its problem as a batch of one.
- Against the port's single-pair calls: the batch equals one call per
  pair field by field, with explicit streams and with a generator, and
  each loop reads the host as often as its slowest pair alone
  (``check_batch_vs_singles``).
- ``run_batch`` against ``run`` per pair on rendered scenes at 240x480.
- Halign's generator order: a single call draws the fallback's streams
  whether the fallback runs or not. The batched Cholesky of BA's camera
  system against float64.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from matchinglib_poselib_tpu import config as jcfg
from matchinglib_poselib_tpu.ops import ba as jba

from matchinglib_poselib_torch.convert import config_from_jax
from matchinglib_poselib_torch.models import pipeline as tp
from matchinglib_poselib_torch.ops import ba as tba
from matchinglib_poselib_torch.ops import geometry as tg
from matchinglib_poselib_torch.ops import robust as trob

from test_pose_branches import DIST, K
from test_torch_helpers import (
    assert_pair_equal, check_batch_vs_singles, check_pose_vs_jax,
    jax_pair_pose_streams, jax_vmap_pose, n, pose_pairs, rot_chordal_deg, t,
)
from test_torch_run_batch import _pipe, _scenes

KEY = jax.random.PRNGKey(11)
ROBUST = jcfg.RobustConfig(batch_hypotheses=64, max_batches=4)
CFGS = {
    "halign": jcfg.PoseConfig(robust=ROBUST, use_halign=True),
    "ba": jcfg.PoseConfig(robust=ROBUST,
                          ba=jcfg.BAConfig(enabled=True, iterations=10)),
}
SPECS = {
    # a general scene, which Halign cannot explain, between planar ones
    "halign": [dict(seed=3, planar=True, outlier_frac=0.15), dict(seed=4),
               dict(seed=5, planar=True, outlier_frac=0.15)],
    "ba": [dict(seed=3), dict(seed=4, noise_px=1.0), dict(seed=5)],
}


def _port_pose(p1, p2, m, q, cfg, **kw):
    return tp.estimate_pose(t(p1), t(p2), t(m), t(q), t(K), t(K), t(DIST),
                            t(DIST), cfg, **kw)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_batched_branch_matches_jax_vmap(name):
    cfg = CFGS[name]
    _, _, p1, p2, m, q = pose_pairs(SPECS[name])
    jpose = jax_vmap_pose(cfg, K, DIST, p1, p2, m, q, KEY)
    tpose = _port_pose(p1, p2, m, q, config_from_jax(cfg),
                       **jax_pair_pose_streams(KEY, 3, cfg))
    check_pose_vs_jax(tpose, jpose)
    if name == "halign":
        # pair 1 falls back to robust E, pairs 0 and 2 keep Halign's pose
        assert n(tpose.halign_error_code).tolist() == [0, -1, 0]


def _stereo_problems():
    """Three two-view BA problems in normalized coordinates: the pairs'
    correspondences and the points triangulated from the planted pose,
    which the start turns by 0.2, 8 and 0.2 deg. The least-squares steps
    of pairs 0 and 2 reach the noise floor after one step, and their
    second is rejected; pair 1 accepts both."""
    R, tt, p1, p2, m, _ = pose_pairs(SPECS["ba"])
    x1, x2 = tg.img_to_cam(t(p1), t(K)), tg.img_to_cam(t(p2), t(K))
    t_gt = tg.normalize_vec(t(tt))
    _, X, ok = tg.cheirality_counts(t(R), t_gt, x1, x2, t(m))
    rng = np.random.default_rng(0)
    axes = rng.normal(size=(3, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    R0 = t(R) @ tba.exp_so3(t(axes * np.deg2rad([[0.2], [8.0], [0.2]])))
    eye = torch.eye(3).expand(3, 3, 3)
    return (torch.stack([x1, x2], dim=-2), torch.stack([ok, ok], -1).float(),
            torch.stack([eye, R0], dim=1),
            torch.stack([torch.zeros(3, 3), t_gt], dim=1),
            torch.eye(3).expand(3, 2, 3, 3), torch.zeros(3, 2, 5), X,
            torch.tensor([0.0, 1.0]))


def test_batched_bundle_adjust_matches_jax_vmap():
    args = _stereo_problems()
    kw = dict(iterations=2, robust=False, huber_delta=1.0 / float(K[0, 0]))
    rj = jax.vmap(lambda *a: jba.bundle_adjust(*a, **kw),
                  in_axes=(0,) * 7 + (None,))(
                      *(jnp.asarray(n(a)) for a in args))
    rt = tba.bundle_adjust(*args, **kw)
    accepted = n(rt.n_iterations).tolist()
    assert accepted == np.asarray(rj.n_iterations).tolist() == [1, 2, 1]
    np.testing.assert_allclose(n(rt.final_cost), np.asarray(rj.final_cost),
                               rtol=1e-3)
    for i in range(3):
        assert rot_chordal_deg(np.asarray(rj.R[i, 1]), n(rt.R[i, 1])) < 5e-3
    np.testing.assert_allclose(n(rt.t), np.asarray(rj.t), atol=1e-3)
    # each pair equals its problem as a batch of one (as estimate_pose
    # runs a single pair)
    for i in range(3):
        one = tba.bundle_adjust(*(a[i:i + 1] for a in args[:7]), args[7],
                                **kw)
        assert torch.equal(one.R[0], rt.R[i]) and torch.equal(
            one.points[0], rt.points[i])


def test_bundle_adjust_ill_conditioned_points_stay_finite():
    """Starts ~1-5 deg and ~0.1 off the planted pose: some points' 3x3
    blocks reach condition ~3e5. Inverted by an f32 adjugate they made
    the Schur complement indefinite (min eigenvalue -2.9e4 for pair 2)
    and the Cholesky NaN, where the JAX package's LU takes its steps; by
    LU every pair stays finite and accepts as many steps as the JAX
    package's (ROADMAP C)."""
    R, tt, p1, p2, m, _ = pose_pairs(SPECS["ba"])
    x1, x2 = tg.img_to_cam(t(p1), t(K)), tg.img_to_cam(t(p2), t(K))
    rng = np.random.default_rng(0)
    R0 = t(R) @ tba.exp_so3(t(rng.normal(size=(3, 3))
                              * np.array([[0.02], [0.08], [0.02]])))
    t0 = tg.normalize_vec(t(tt + rng.normal(scale=0.1, size=tt.shape)))
    _, X, ok = tg.cheirality_counts(R0, t0, x1, x2, t(m))
    eye = torch.eye(3).expand(3, 3, 3)
    args = (torch.stack([x1, x2], dim=-2), torch.stack([ok, ok], -1).float(),
            torch.stack([eye, R0], dim=1),
            torch.stack([torch.zeros(3, 3), t0], dim=1),
            torch.eye(3).expand(3, 2, 3, 3), torch.zeros(3, 2, 5), X,
            torch.tensor([0.0, 1.0]))
    kw = dict(iterations=3, robust=True, huber_delta=1.0 / float(K[0, 0]))
    rj = jax.vmap(lambda *a: jba.bundle_adjust(*a, **kw),
                  in_axes=(0,) * 7 + (None,))(
                      *(jnp.asarray(n(a)) for a in args))
    rt = tba.bundle_adjust(*args, **kw)
    assert np.isfinite(n(rt.final_cost)).all()
    assert (n(rt.final_cost) < n(rt.initial_cost)).all()
    np.testing.assert_array_equal(n(rt.n_iterations),
                                  np.asarray(rj.n_iterations))


@pytest.mark.parametrize("streams", ["explicit", "generator"])
@pytest.mark.parametrize("name", sorted(CFGS))
def test_batched_branch_equals_single_calls(name, streams):
    cfg = CFGS[name]
    _, _, p1, p2, m, q = pose_pairs(SPECS[name])
    pts = (t(p1), t(p2), t(m), t(q))

    def estimate(a, b, c, d, cfg, **kw):
        return tp.estimate_pose(a, b, c, d, t(K), t(K), t(DIST), t(DIST),
                                cfg, **kw)

    check_batch_vs_singles(
        estimate, pts, config_from_jax(cfg),
        jax_pair_pose_streams(KEY, 3, cfg) if streams == "explicit"
        else None)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_run_batch_branch_matches_run_per_pair(name):
    imgs1, imgs2, Ks, _, _ = _scenes((0, 1))
    pipe = _pipe(config_from_jax(CFGS[name]))
    args = (t(Ks), t(Ks), torch.zeros(5), torch.zeros(5))
    corr, pose = pipe.run_batch(imgs1, imgs2, *args,
                                torch.Generator().manual_seed(4))
    gen = torch.Generator().manual_seed(4)
    for i in range(2):
        c, p = pipe.run(imgs1[i], imgs2[i], *args, gen)
        assert_pair_equal(corr, pose, c, p, i)


@pytest.mark.parametrize("pair", [2, 1])
def test_halign_generator_draws_fallback_streams(pair):
    """A single Halign call from a generator draws its plane streams, then
    the fallback's E streams, whether the fallback runs (pair 1, code not
    0) or not (pair 2): the generator ends where those draws leave it."""
    cfg = config_from_jax(CFGS["halign"])
    _, _, p1, p2, m, q = pose_pairs(SPECS["halign"])
    g = torch.Generator().manual_seed(8)
    pose = _port_pose(p1[pair], p2[pair], m[pair], q[pair], cfg,
                      generator=g)
    assert (int(pose.halign_error_code) == 0) == (pair == 2)
    e_shape, _ = trob.sample_shapes(cfg.robust)
    want = torch.Generator().manual_seed(8)
    torch.rand((cfg.halign.max_planes, *e_shape[:2], 4), generator=want)
    torch.rand(e_shape, generator=want)
    assert torch.equal(g.get_state(), want.get_state())


def test_batched_cholesky_matches_float64():
    """BA's camera-system solve on a stack of random SPD systems with a
    spread of scales, against float64, system by system."""
    rng = np.random.default_rng(1)
    A = rng.normal(size=(4, 12, 12))
    A = A @ A.transpose(0, 2, 1) + 0.1 * np.eye(12)
    s = np.exp(rng.uniform(-3, 3, (4, 12)))
    A = A * s[:, :, None] * s[:, None, :]
    b = rng.normal(size=(4, 12))
    x = n(tba._chol_solve(t(A), t(b)))
    x64 = np.linalg.solve(A, b[..., None])[..., 0]
    assert (np.abs(x - x64).max(-1) <= 1e-3 * np.abs(x64).max(-1)).all()
