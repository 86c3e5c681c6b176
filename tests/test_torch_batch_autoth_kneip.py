"""AutoTh and the Kneip refine of ``estimate_pose`` with a pair axis.

- Against the JAX package: the port's batched ``estimate_pose`` against
  ``jax.vmap`` of the JAX package's on 3 synthetic pairs
  (``test_torch_helpers.pose_pairs``, 64 x 4 hypotheses), pair i's streams
  from the i-th key of ``split(PRNGKey(11), 3)``
  (``jax_pair_pose_streams``): inlier masks on >= 99.5% of the slots, R
  within 0.01 deg (chordal) and t within 0.05 deg (Kneip: 0.1 / 0.25),
  the Halign code and the degeneracy flag equal
  (``check_pose_vs_jax``). AutoTh alone (``estimate_essential_autoth``)
  against ``jax.vmap`` of the JAX package's on pairs at 0.4, 1.6 and
  3.0 px of noise, which latch at different rounds: round counts equal
  and not all the same, thresholds within 1e-4 relative. At seeds 3-5
  the same bars hold for pairs 1 and 2; pair 0 sits on a float32 tie of
  the JAX package's own, and its pose is held to one that the JAX package
  reaches on the pair moved by at most one ulp.
- Against the port's single-pair calls: the batch equals one call per
  pair field by field, with explicit streams and with a generator, and
  each loop reads the host as often as its slowest pair alone
  (``check_batch_vs_singles``).
- ``run_batch`` against ``run`` per pair on rendered scenes at 240x480.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from matchinglib_poselib_tpu import config as jcfg
from matchinglib_poselib_tpu.ops import geometry as jg
from matchinglib_poselib_tpu.ops import robust as jrob

from matchinglib_poselib_torch.convert import config_from_jax
from matchinglib_poselib_torch.models import pipeline as tp
from matchinglib_poselib_torch.ops import robust as trob

from test_pose_branches import DIST, K
from test_torch_helpers import (
    BRANCH_AGREE, BRANCH_DEG, KNEIP_DEG, assert_pair_equal,
    check_batch_vs_singles, check_pose_vs_jax, dir_angle_deg,
    jax_autoth_uniforms, jax_pair_pose_streams, jax_vmap_pose, n,
    pose_pairs, rot_chordal_deg, t,
)
from test_torch_run_batch import _pipe, _scenes

KEY = jax.random.PRNGKey(11)
ROBUST = jcfg.RobustConfig(batch_hypotheses=64, max_batches=4)
CFGS = {
    "auto_th": jcfg.PoseConfig(robust=ROBUST, auto_th=True),
    "kneip": jcfg.PoseConfig(robust=ROBUST, refine=jcfg.RefinementConfig(
        solver=jcfg.MinimalSolver.KNEIP)),
}
# AutoTh: noise levels that latch after 1, 2 and 3 rounds
SPECS = {
    "auto_th": [dict(seed=6, noise_px=0.4), dict(seed=7, noise_px=1.6),
                dict(seed=8, noise_px=3.0)],
    "kneip": [dict(seed=3), dict(seed=4), dict(seed=5)],
}
# AutoTh at seeds 3-5: pair 0 sits on a tie of the JAX package's own
# (test_batched_autoth_tie_pair_is_a_tie_of_the_jax_package)
TIE_SPECS = [dict(seed=3, noise_px=0.4), dict(seed=4, noise_px=1.6),
             dict(seed=5, noise_px=3.0)]
# one-ulp moves of the tie pair's pixels: batches of 3 copies, rng seeds
TIE_BATCHES = 10


def _pairs(pose, idx):
    """The pairs idx of a batched PoseResult of either package."""
    return type(pose)(*(f[np.asarray(idx)] for f in pose))


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
    check_pose_vs_jax(tpose, jpose, **({"deg": KNEIP_DEG}
                                       if name == "kneip" else {}))


def _within_bars(R, t_, R_ref, t_ref):
    return (rot_chordal_deg(R_ref, R) < BRANCH_DEG[0]
            and dir_angle_deg(t_ref, t_) < BRANCH_DEG[1])


def _ulp_copies(x, rng):
    """3 copies of x (float32), each coordinate moved by -1, 0 or +1 ulp
    (relative float32 eps)."""
    eps = np.finfo(np.float32).eps
    return (x * (1 + eps * rng.integers(-1, 2, size=(3,) + x.shape))
            ).astype(np.float32)


def test_batched_autoth_tie_pair_is_a_tie_of_the_jax_package():
    """AutoTh at seeds 3-5 (PRNGKey(11)): pairs 1 and 2 meet the bars
    against ``jax.vmap`` of the JAX package. Pair 0's masks, code and
    degeneracy flag meet them too; its pose is one that the JAX package
    itself reaches on the same pair at float32 precision: the IRLS
    refine's inlier set (``refine_essential_linear``) turns on rounding
    there and sends the LM polish to one of two fixed points, slot 191 in
    or out, 0.012 deg and 0.084 deg apart. Shown here: on 30 copies of
    the pair, each pixel moved by at most one ulp, under the pair's key,
    the JAX package reaches poses farther apart than the bars, and the
    port's pose is within the bars of the JAX package's on the pair or
    on one of the copies (at these rng seeds the JAX package lands on the
    port's pose 3 times in 30, on its own 27 times)."""
    from matchinglib_poselib_tpu.models import pipeline as jp

    cfg = CFGS["auto_th"]
    _, _, p1, p2, m, q = pose_pairs(TIE_SPECS)
    jpose = jax_vmap_pose(cfg, K, DIST, p1, p2, m, q, KEY)
    tpose = _port_pose(p1, p2, m, q, config_from_jax(cfg),
                       **jax_pair_pose_streams(KEY, 3, cfg))
    check_pose_vs_jax(_pairs(tpose, [1, 2]), _pairs(jpose, [1, 2]))
    agree = (n(tpose.inlier_mask[0]) == np.asarray(jpose.inlier_mask[0]))
    assert agree.mean() >= BRANCH_AGREE
    assert int(tpose.halign_error_code[0]) == int(jpose.halign_error_code[0])
    assert bool(tpose.is_degenerate[0]) == bool(jpose.is_degenerate[0])

    Kj, dj = jnp.asarray(K), jnp.asarray(DIST)
    key0 = jnp.stack([jax.random.split(KEY, 3)[0]] * 3)
    poses = [(np.asarray(jpose.R[0]), np.asarray(jpose.t[0]))]
    for c in range(TIE_BATCHES):
        rng = np.random.default_rng(c)
        r = jax.vmap(lambda a, b, c_, d, kk: jp.estimate_pose(
            a, b, c_, d, Kj, Kj, dj, dj, cfg, kk))(
                jnp.asarray(_ulp_copies(p1[0], rng)),
                jnp.asarray(_ulp_copies(p2[0], rng)),
                jnp.asarray(np.stack([m[0]] * 3)),
                jnp.asarray(np.stack([q[0]] * 3)), key0)
        poses += [(np.asarray(r.R[j]), np.asarray(r.t[j]))
                  for j in range(3)]
    # the JAX package's answers for the pair split beyond the bars ...
    assert not all(_within_bars(*p, *poses[0]) for p in poses)
    # ... and the port's is one of them
    assert any(_within_bars(n(tpose.R[0]), n(tpose.t[0]), *p)
               for p in poses)


def test_batched_autoth_latches_per_pair_as_jax_vmap():
    cfg = CFGS["auto_th"]
    _, _, p1, p2, m, q = pose_pairs(SPECS["auto_th"])
    x1 = np.asarray(jg.img_to_cam(jnp.asarray(p1), jnp.asarray(K)))
    x2 = np.asarray(jg.img_to_cam(jnp.asarray(p2), jnp.asarray(K)))
    f = float(K[0, 0])
    th = cfg.robust.threshold_px / f
    kw = dict(threshold_sq=th * th, min_threshold=jcfg.MIN_PIX_TH / f,
              max_threshold=jcfg.MAX_PIX_TH / f)
    keys = jax.random.split(KEY, 3)
    rj = jax.vmap(lambda a, b, c, d, kk: jrob.estimate_essential_autoth(
        a, b, c, d, cfg.robust, kk, **kw))(
            jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(m, jnp.float32),
            jnp.asarray(q), keys)
    (nb, B, k), _ = trob.sample_shapes(cfg.robust)
    u, d = zip(*(jax_autoth_uniforms(kk, 3, nb, B, k) for kk in keys))
    rt = trob.estimate_essential_autoth(
        t(x1), t(x2), t(m).float(), t(q), config_from_jax(cfg.robust), **kw,
        uniforms=torch.stack(u), degen_uniforms=torch.stack(d))
    rounds = n(rt.n_rounds).tolist()
    assert rounds == np.asarray(rj.n_rounds).tolist()
    assert len(set(rounds)) > 1, rounds
    np.testing.assert_allclose(n(rt.threshold), np.asarray(rj.threshold),
                               rtol=1e-4)
    agree = (n(rt.result.inlier_mask)
             == np.asarray(rj.result.inlier_mask)).mean(axis=1)
    assert (agree >= 0.995).all(), agree
    np.testing.assert_array_equal(n(rt.degen.is_degenerate),
                                  np.asarray(rj.degen.is_degenerate))


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
