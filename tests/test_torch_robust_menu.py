"""The rest of the robust menu: LMEDS scoring and the Stewenius five-point
solver, port vs JAX package.

- The Stewenius table regenerated from the seed equals the JAX package's
  ``solvers._VINV_T`` bit for bit, and so does the tan scan's theta grid.
- ``solve_5pt`` (Stewenius) on 96 minimal samples: its sign scan and
  bisection decide weakly crossing roots on f32 sign flips, and the
  port's Hyman recurrence sums each row as one reduction where the JAX
  package sums term by term, so a root can be found on one side only (as
  with the Nister solver, test_torch_solvers.py). Bound: >= 90% of the
  JAX package's valid models covered by a port model within 1e-4, every
  port model's epipolar residual on its five points below 1e-5, and the
  true model found as often (within 2 samples). The Hessenberg
  reduction is held by its properties and the JAX package's sign rule;
  Hyman's determinant on the same H within 5e-4 of its largest value
  over the shifts, its vector within 1e-4 relative.
- ``ransac`` (through ``estimate_essential_robust`` without LO and the
  degeneracy check) and ``estimate_pose``, each with LMEDS and with the
  Stewenius solver, fed the JAX sampler's uniforms: inlier masks equal,
  poses within 0.0015 deg (rotation) and 0.023 deg (translation
  direction) and LMEDS runs every batch. LMEDS's final threshold, its
  (2.5 * 1.4826 * sqrt(median))^2 band: within 1e-6 relative of the JAX
  package's when evaluated on the JAX package's model, within 1e-3 on
  the port's own model (the solvers' f32 rounding moves the median).
- ``run_batch`` with LMEDS, with the Stewenius solver and with both,
  equal to ``run`` on each of P = 3 pairs (the bars of
  test_torch_run_batch.py (c)); LMEDS's batch loop reads the host never.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from matchinglib_poselib_tpu import config as jcfg
from matchinglib_poselib_tpu.models import pipeline as jp
from matchinglib_poselib_tpu.ops import robust as jrob
from matchinglib_poselib_tpu.ops import solvers as js

from matchinglib_poselib_torch import config as tcfg
from matchinglib_poselib_torch import convert
from matchinglib_poselib_torch.models import pipeline as tp
from matchinglib_poselib_torch.ops import geometry as tg
from matchinglib_poselib_torch.ops import robust as trob
from matchinglib_poselib_torch.ops import solvers as ts
from matchinglib_poselib_torch.utils.profiling import (
    HostSyncs, loop_iterations,
)

from conftest import random_pose, synthetic_correspondences
from test_torch_helpers import (
    assert_pair_equal, dir_angle_deg, jax_degen_uniforms, jax_pair_streams,
    jax_uniforms, n, rot_chordal_deg, t,
)
from test_torch_run_batch import FAST, KS, _scenes, _synthetic
from test_torch_solvers import _covered, _samples, _sign_free_dist, _unit

ROT_DEG, TANG_DEG = 0.0015, 0.023
LMEDS_TH_RTOL = 1e-6
LMEDS_MODEL_TH_RTOL = 1e-3
MENU = {
    "lmeds": dict(estimator="LMEDS"),
    "stewenius": dict(solver="STEWENIUS_5PT"),
}


def _robust_kw(pkg, option):
    kw = {}
    for k, v in MENU[option].items():
        enum = pkg.PoseEstimator if k == "estimator" else pkg.MinimalSolver
        kw[k] = enum[v]
    return kw


# ---------------------------------------------------------------------------
# the Stewenius solver
# ---------------------------------------------------------------------------


def test_stewenius_tables_regenerate_bit_for_bit():
    np.testing.assert_array_equal(ts.SolverTables().vinv_t_stewenius.numpy(),
                                  np.asarray(js._VINV_T))
    np.testing.assert_array_equal(
        ts.stewenius_vinv_t(ts.pick_interpolation_points()).astype(
            np.float32), np.asarray(js._VINV_T))
    _, st = convert.tables_from_numpy(
        np.zeros((30, 512), np.int32), np.asarray(js._INTERP_PTS),
        np.asarray(js._VINV_T_NISTER), np.asarray(js._VINV_T))
    np.testing.assert_array_equal(st.vinv_t_stewenius.numpy(),
                                  np.asarray(js._VINV_T))
    grid = jnp.linspace(-jnp.pi / 2 + 1e-3, jnp.pi / 2 - 1e-3, 129,
                        dtype=jnp.float32)
    np.testing.assert_array_equal(ts.SolverTables().theta_hess.numpy(),
                                  np.asarray(grid))


@pytest.fixture(scope="module")
def stewenius_vs_jax():
    x1, x2, poses = _samples(6, 96, 5)
    rE, rv = js.solve_5pt(jnp.asarray(x1), jnp.asarray(x2))
    oE, ov = ts.solve_5pt(t(x1), t(x2))
    return x1, x2, poses, np.asarray(rE), np.asarray(rv), n(oE), n(ov)


def test_solve_5pt_stewenius_models_match(stewenius_vs_jax):
    x1, x2, poses, rE, rv, oE, ov = stewenius_vs_jax
    assert rv.sum() >= 96
    assert _covered(rE, rv, oE, ov).mean() >= 0.9
    h1 = np.concatenate([x1, np.ones_like(x1[..., :1])], -1)
    h2 = np.concatenate([x2, np.ones_like(x2[..., :1])], -1)
    res = np.abs(np.einsum("bni,brij,bnj->brn", h2, _unit(oE), h1))
    assert np.all(res[ov] < 1e-5)

    def true_found(E, v):
        return sum(
            bool(v[b].any()) and _sign_free_dist(
                _unit(E[b][v[b]]), _unit(np.cross(np.eye(3), tt) @ R)
            ).min() < 1e-3
            for b, (R, tt) in enumerate(poses)
        )

    # the true model as often as in the JAX package, which misses it on
    # ~9% of these samples itself (a near-double root without a sign
    # change on the scan grid)
    n_jax, n_port = true_found(rE, rv), true_found(oE, ov)
    assert n_port >= n_jax - 2, (n_port, n_jax)


def test_stewenius_building_blocks_match():
    """The action matrix, its Hessenberg form (M = Q H Q^T) and Hyman's
    determinant and back-substituted vector at shifts across the grid."""
    x1, x2, _ = _samples(7, 16, 5)
    ns = ts.nullspace_qr(ts.epipolar_rows(t(x1), t(x2)))
    Eb = ns.transpose(-1, -2).reshape(16, 4, 3, 3)
    tab = ts.default_tables("cpu")
    C = ts._constraint_values(Eb, tab.interp_pts) @ tab.vinv_t_stewenius
    Mt, okt = ts._action_matrix(C)
    Mj, okj = js._action_matrix(jnp.asarray(n(C)))
    np.testing.assert_array_equal(n(okt), np.asarray(okj))
    np.testing.assert_allclose(n(Mt), np.asarray(Mj), rtol=1e-4, atol=1e-4)
    M = np.asarray(Mj)
    Hj, _ = js.hessenberg(jnp.asarray(M))
    Ht, Qt = ts.hessenberg(t(M))
    # a reduction of M: Q orthogonal, H upper Hessenberg, M = Q H Q^T.
    # Entry by entry the two packages' H differ as M's conditioning
    # amplifies the order of their f32 sums (up to 4e-3 of max |M| at
    # cond(M) ~ 1e5 here), so H is held by the reduction and by the sign
    # rule: every clearly nonzero subdiagonal entry has the JAX package's
    # sign
    scale = np.abs(M).max(axis=(-1, -2), keepdims=True)
    Ht, Qt, Hj = n(Ht), n(Qt), np.asarray(Hj)
    eye = np.eye(10, dtype=np.float32)
    assert np.abs(Qt @ Qt.transpose(0, 2, 1) - eye).max() < 1e-5
    assert (np.abs(Qt @ Ht @ Qt.transpose(0, 2, 1) - M) / scale).max() < 1e-5
    assert np.all(np.abs(np.tril(Ht, -2)) <= 1e-5 * scale)
    sub_t = np.diagonal(Ht, offset=-1, axis1=-2, axis2=-1)
    sub_j = np.diagonal(Hj, offset=-1, axis1=-2, axis2=-1)
    clear = np.abs(sub_j) > 1e-3 * scale[..., 0]
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(np.sign(sub_t)[clear],
                                  np.sign(sub_j)[clear])
    lam = np.tan(np.linspace(-1.5, 1.5, 9)).astype(np.float32)
    H = np.asarray(Hj)
    rj, xj = js._hyman(jnp.asarray(H)[:, None],
                       jnp.broadcast_to(jnp.asarray(lam), (16, 9)))
    rt, xt = ts._hyman(t(H)[:, None], t(lam).expand(16, 9))
    rj = np.asarray(rj)
    # r within 5e-4 of its largest value over the grid (measured 1.3e-4:
    # the row sums' order)
    assert (np.abs(n(rt) - rj) / np.abs(rj).max(-1, keepdims=True)).max() < (
        5e-4)
    np.testing.assert_allclose(n(xt), np.asarray(xj), rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# ransac and estimate_pose with LMEDS and with the Stewenius solver
# ---------------------------------------------------------------------------

TH = 3e-3
RANSAC = dict(batch_hypotheses=64, max_batches=4, threshold_px=TH,
              lo_refine=False, check_degeneracy=False)


def _scene(seed, n_pts=256):
    rng = np.random.default_rng(seed)
    R, tt = random_pose(rng, 12.0)
    x1, x2 = synthetic_correspondences(rng, R, tt, n_pts, noise=1e-3,
                                       outlier_frac=0.3)
    return (x1.astype(np.float32), x2.astype(np.float32),
            rng.uniform(0.0, 1.0, n_pts).astype(np.float32))


def _pose_deg(E_j, E_t, x1, x2, inl):
    """Rotation and translation-direction differences of the poses the
    port recovers from the two models on the same inliers."""
    w = t(inl.astype(np.float32))
    Rj, tj, _, _, _ = tg.recover_pose(t(E_j), t(x1), t(x2), w)
    Rt, tt, _, _, _ = tg.recover_pose(E_t, t(x1), t(x2), w)
    return rot_chordal_deg(n(Rj), n(Rt)), dir_angle_deg(n(tj), n(tt))


@pytest.mark.parametrize("option", sorted(MENU))
def test_ransac_menu_matches_jax(option):
    x1, x2, q = _scene(11)
    mask = np.ones(len(x1), np.float32)
    key = jax.random.PRNGKey(5)
    rj, _ = jrob.estimate_essential_robust(
        jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(mask), jnp.asarray(q),
        jcfg.RobustConfig(**RANSAC, **_robust_kw(jcfg, option)), key,
        threshold_sq=TH * TH, prior_inlier_ratio=0.5)
    cfg = tcfg.RobustConfig(**RANSAC, **_robust_kw(tcfg, option))
    with HostSyncs.traced() as log:
        rt, _ = trob.estimate_essential_robust(
            t(x1), t(x2), t(mask), t(q), cfg, threshold_sq=TH * TH,
            prior_inlier_ratio=0.5, uniforms=jax_uniforms(key, 4, 64, 5))
    np.testing.assert_array_equal(n(rt.inlier_mask),
                                  np.asarray(rj.inlier_mask))
    assert int(rt.n_batches) == int(rj.n_batches)
    dr, dtr = _pose_deg(np.asarray(rj.model), rt.model, x1, x2,
                        np.asarray(rj.inlier_mask))
    assert dr < ROT_DEG and dtr < TANG_DEG, (dr, dtr)
    if option == "lmeds":
        assert int(rt.n_batches) == cfg.max_batches
        assert not log, log
        # the band on the JAX package's own model within 1e-6; the
        # models differ by the solvers' f32 rounding, which moves the
        # median residual by ~2e-4 of itself (measured 1.8e-4)
        thj = float(rj.threshold)
        err = tg.sampson_error(t(np.asarray(rj.model)), t(x1), t(x2))
        s = 2.5 * 1.4826 * torch.sqrt(torch.clamp(
            tg.masked_median(err, t(mask).bool()), min=1e-20))
        assert abs(float(s * s) - thj) <= LMEDS_TH_RTOL * thj
        assert abs(float(rt.threshold) - thj) <= LMEDS_MODEL_TH_RTOL * thj
        # the band is the robust sigma of the residuals, not the input
        assert thj != pytest.approx(TH * TH)


@pytest.mark.parametrize("option", sorted(MENU))
def test_estimate_pose_menu_matches_jax(option):
    p1, p2, m, q = _synthetic(pairs=((0.7, 240),), seed=8)
    p1, p2, m, q = p1[0], p2[0], m[0], q[0]
    rob = dict(batch_hypotheses=64, max_batches=4)
    key = jax.random.PRNGKey(9)
    jpose = jp.estimate_pose(
        jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(m), jnp.asarray(q),
        jnp.asarray(KS), jnp.asarray(KS), jnp.zeros(5), jnp.zeros(5),
        jcfg.PoseConfig(robust=jcfg.RobustConfig(
            **rob, **_robust_kw(jcfg, option))), key)
    cfg = tcfg.PoseConfig(robust=tcfg.RobustConfig(
        **rob, **_robust_kw(tcfg, option)))
    tpose = tp.estimate_pose(
        t(p1), t(p2), torch.from_numpy(m), t(q), t(KS), t(KS),
        torch.zeros(5), torch.zeros(5), cfg,
        uniforms=jax_uniforms(key, 4, 64, 5),
        degen_uniforms=jax_degen_uniforms(key, 64))
    np.testing.assert_array_equal(n(tpose.inlier_mask),
                                  np.asarray(jpose.inlier_mask))
    dr = rot_chordal_deg(np.asarray(jpose.R), n(tpose.R))
    dtr = dir_angle_deg(np.asarray(jpose.t), n(tpose.t))
    assert dr < ROT_DEG and dtr < TANG_DEG, (dr, dtr)
    assert int(tpose.n_models_generated) == int(jpose.n_models_generated)
    assert bool(tpose.is_degenerate) == bool(jpose.is_degenerate)
    if option == "lmeds":
        assert int(tpose.n_models_generated) == 4 * 64 * 10


# ---------------------------------------------------------------------------
# run_batch with the options, pair by pair against run
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("options", [("lmeds",), ("stewenius",),
                                     ("lmeds", "stewenius")])
def test_run_batch_menu_matches_run_per_pair(options):
    kw = {}
    for o in options:
        kw.update(_robust_kw(tcfg, o))
    cfg = tcfg.PoseConfig(robust=tcfg.RobustConfig(batch_hypotheses=64,
                                                   max_batches=4, **kw))
    imgs1, imgs2, K, _, _ = _scenes((0, 1, 2))
    pipe = tp.StereoPipeline(tcfg.DetectorConfig(**FAST),
                             pose_cfg=cfg, device="cpu")
    args = (t(K), t(K), torch.zeros(5), torch.zeros(5))
    U, D = jax_pair_streams(jax.random.PRNGKey(4), 3, cfg.robust)
    with HostSyncs.traced() as log:
        corr, pose = pipe.run_batch(imgs1, imgs2, *args, uniforms=U,
                                    degen_uniforms=D)
    for i in range(3):
        c, p = pipe.run(imgs1[i], imgs2[i], *args, uniforms=U[i],
                        degen_uniforms=D[i])
        assert_pair_equal(corr, pose, c, p, i)
    if "lmeds" in options:
        # the host reads only in the degeneracy check's single batch
        ransac_runs = [k for (site, _), k in loop_iterations(log).items()
                       if site == "ransac"]
        assert ransac_runs and max(ransac_runs) == 1, ransac_runs
        assert (n(pose.n_models_generated) == 4 * 64 * 10).all()
