"""The batched flagship step: StereoPipeline.run_batch and estimate_pose
with a leading pair axis, against the JAX package and against the port's
own single-pair calls.

- (a) JAX ``StereoPipeline.run_batch`` (``jax.vmap`` of the whole program)
  against the port's ``run_batch(device="cpu")`` on 3 seeded scenes at
  240x480 (FAST, 512 slots in 8 bands, ORB, GMBSOF, 64 x 4 five-point
  hypotheses); the port draws pair i's streams from the i-th key of
  ``split(PRNGKey, 3)``, as the JAX package does. FAST keypoint slots
  exact; match slots held to test_torch_pipeline._check's bars (masks on
  >= 99% of slots, partners within 1e-5); inlier masks equal; poses
  within 0.1 deg (rotation) and 0.5 deg (translation direction); per
  pair, the batches (models generated) and LO refinements equal, the
  invalid solver outputs within 2% of the models generated
  (``_check_counters_vs_jax``; single-pair calls of the two packages, and
  the JAX package's vmap against its own single-pair calls, differ as
  much: ``test_single_pair_counters_match_jax``).
- (b) the batched ``estimate_pose`` against ``jax.vmap(estimate_pose)`` on
  synthetic correspondences of 4 pairs (inlier ratios 0.9, 0.6 and 0.3,
  and a pair with 12 valid slots) that leave the robust loop at different
  batches: the same bars.
- (c) ``run_batch`` against ``run`` on each pair, with explicit streams
  and with one seeded generator (sequential ``run`` calls on the same
  generator), P = 3 and P = 1, and at the SIFT + GMS and SURF configs:
  slots exact, masks and counters equal, R, t and E within 1e-5 (on the
  CPU they come out bit-equal: a single pair runs as a batch of one).
- (d) each flag option of the default pose branch, batched against
  per-pair calls of the port: masks and counters equal, R and t within
  1e-5; each run of each data-dependent loop reads the host as often as
  its slowest pair alone.
- (e) inconsistent shapes, a pair-axis stream of the wrong shape (before
  any work) and a card that is not there raise.
- (f) the closed-form Jacobian of the LM polish against
  ``torch.func.jacfwd`` in float64.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from matchinglib_poselib_tpu import config as jcfg
from matchinglib_poselib_tpu.models import pipeline as jp

from matchinglib_poselib_torch import config as tcfg
from matchinglib_poselib_torch.models import pipeline as tp
from matchinglib_poselib_torch.ops import refine as trf
from matchinglib_poselib_torch.ops import robust as trob
from matchinglib_poselib_torch.utils.profiling import (
    HostSyncs, loop_iterations,
)

from chip_smoke import render_scene
from conftest import random_pose, synthetic_correspondences
from test_torch_helpers import (
    COUNTERS, assert_pair_equal, assert_pose_equal, dir_angle_deg,
    jax_pair_streams, n, rot_angle_deg, t,
)

FAST = dict(kind="FAST", max_keypoints=512, fast_threshold=12.0,
            column_bands=8)
ROBUST = dict(batch_hypotheses=64, max_batches=4)
SEEDS = (0, 1, 2)
REJECTED_RTOL = 0.02


def _scenes(seeds, height=240, width=480):
    """Seeded scenes: (imgs1 (P, H, W), imgs2, K, planted R, t)."""
    scenes = [render_scene(s, width, height) for s in seeds]
    return (np.stack([s[0] for s in scenes]), np.stack([s[1] for s in scenes]),
            scenes[0][2], scenes[0][3], scenes[0][4])


def _pipe(pose=None, det=FAST, device="cpu"):
    return tp.StereoPipeline(
        tcfg.DetectorConfig(**det), tcfg.DescriptorConfig(),
        tcfg.MatchingConfig(),
        pose or tcfg.PoseConfig(robust=tcfg.RobustConfig(**ROBUST)),
        device=device)


def _counters(pose, i):
    return {c: int(n(getattr(pose, c))[i]) for c in COUNTERS}


def _check_counters_vs_jax(got, want):
    """Counters of one pair: batches (hence models generated) and LO
    refinements equal; invalid solver outputs within REJECTED_RTOL of the
    models generated (the five-point solver's root scan decides near-ties
    in f32 on either side: single-pair calls differ as much,
    ``test_single_pair_counters_match_jax``), and the points verified
    follow from them."""
    for c in ("n_models_generated", "n_lo_refinements"):
        assert got[c] == want[c], (c, got[c], want[c])
    gen = got["n_models_generated"]
    assert abs(got["n_models_rejected"] - want["n_models_rejected"]) <= (
        REJECTED_RTOL * gen), (got, want)
    n_valid = want["n_points_verified"] // max(
        gen - want["n_models_rejected"], 1)
    assert got["n_points_verified"] == (
        gen - got["n_models_rejected"]) * n_valid, (got, want)


def _check_pose_vs_jax(tpose, jpose, i):
    np.testing.assert_array_equal(n(tpose.inlier_mask[i]),
                                  np.asarray(jpose.inlier_mask[i]))
    _check_counters_vs_jax(_counters(tpose, i), _counters(jpose, i))
    assert rot_angle_deg(np.asarray(jpose.R[i]), n(tpose.R[i])) < 0.1
    assert dir_angle_deg(np.asarray(jpose.t[i]), n(tpose.t[i])) < 0.5


# ---------------------------------------------------------------------------
# (a) the JAX package's run_batch
# ---------------------------------------------------------------------------


def _run_batch_both(seeds, height, width, det, robust):
    imgs1, imgs2, K, R, tt = _scenes(seeds, height, width)
    key = jax.random.PRNGKey(7)
    jpipe = jp.StereoPipeline(
        jcfg.DetectorConfig(**det), jcfg.DescriptorConfig(),
        jcfg.MatchingConfig(),
        jcfg.PoseConfig(robust=jcfg.RobustConfig(**robust)))
    jcorr, jpose = jpipe.run_batch(
        jnp.asarray(imgs1), jnp.asarray(imgs2), jnp.asarray(K),
        jnp.asarray(K), jnp.zeros(5), jnp.zeros(5), key)
    pose_cfg = tcfg.PoseConfig(robust=tcfg.RobustConfig(**robust))
    U, D = jax_pair_streams(key, len(seeds), pose_cfg.robust)
    pipe = _pipe(pose_cfg, det)
    tcorr, tpose = pipe.run_batch(t(imgs1), t(imgs2), t(K), t(K),
                                  torch.zeros(5), torch.zeros(5),
                                  uniforms=U, degen_uniforms=D)
    return jcorr, jpose, tcorr, tpose, R, tt, pipe


def _check_vs_jax(jcorr, jpose, tcorr, tpose, R, tt):
    for i in range(tcorr.mask.shape[0]):
        for side in ("kps1", "kps2"):
            jk, tk = getattr(jcorr, side), getattr(tcorr, side)
            np.testing.assert_array_equal(n(tk.mask[i]),
                                          np.asarray(jk.mask[i]))
            np.testing.assert_allclose(n(tk.xy[i]), np.asarray(jk.xy[i]),
                                       atol=1e-5)
        jm, tm = np.asarray(jcorr.mask[i]), n(tcorr.mask[i])
        assert (jm == tm).mean() >= 0.99
        both = jm & tm
        np.testing.assert_allclose(n(tcorr.pts2[i])[both],
                                   np.asarray(jcorr.pts2[i])[both],
                                   atol=1e-5)
        _check_pose_vs_jax(tpose, jpose, i)
        for pose in (jpose, tpose):
            assert rot_angle_deg(R, np.asarray(n(pose.R[i]))) < 1.0
            assert dir_angle_deg(tt, np.asarray(n(pose.t[i]))) < 5.0


@pytest.fixture(scope="module")
def batch_vs_jax():
    return _run_batch_both(SEEDS, 240, 480, FAST, ROBUST)


def test_run_batch_matches_jax_run_batch(batch_vs_jax):
    jcorr, jpose, tcorr, tpose, R, tt, pipe = batch_vs_jax
    assert tcorr.mask.shape == (3, 512) and tpose.R.shape == (3, 3, 3)
    _check_vs_jax(jcorr, jpose, tcorr, tpose, R, tt)
    assert (n(tcorr.n) >= 100).all() and (n(tpose.n_inliers) >= 80).all()
    assert set(pipe.timer.times_ms) == {
        "keypoints", "descriptors", "matching", "robEstimationAndRef"}


@pytest.mark.slow
def test_run_batch_full_size_matches_jax():
    """The flagship config at 1392x512 (2048 slots, 96 x 12), P = 2."""
    out = _run_batch_both((0, 1), 512, 1392,
                          dict(FAST, max_keypoints=2048, column_bands=16),
                          dict(batch_hypotheses=96, max_batches=12))
    _check_vs_jax(*out[:6])


# ---------------------------------------------------------------------------
# (b) jax.vmap(estimate_pose) on synthetic correspondences
# ---------------------------------------------------------------------------

F, CX, CY = 700.0, 320.0, 240.0
KS = np.array([[F, 0, CX], [0, F, CY], [0, 0, 1.0]], np.float32)
SLOTS = 256
# (inlier ratio, valid slots) per pair: easy, harder, hard, nearly empty
PAIRS = ((0.9, 240), (0.6, 240), (0.3, 240), (0.9, 12))
# compaction caps under the slot count, so that the batched gathers run
SYN_REFINE = dict(refine_max_points=128, polish_max_points=128)


def _synthetic(pairs=PAIRS, seed=5):
    """Pixel correspondences of len(pairs) scenes, SLOTS slots each: the
    valid slots first, the given share of them outliers."""
    rng = np.random.default_rng(seed)
    pts1, pts2, mask, quality = [], [], [], []
    for ratio, valid in pairs:
        R, tt = random_pose(rng, 15.0)
        x1, x2 = synthetic_correspondences(rng, R, tt, SLOTS,
                                           noise=0.4 / F)
        out = rng.permutation(valid)[:int(round((1.0 - ratio) * valid))]
        x2[out] = rng.uniform(-0.4, 0.4, size=(len(out), 2))
        pts1.append(x1 * F + [CX, CY])
        pts2.append(x2 * F + [CX, CY])
        mask.append(np.arange(SLOTS) < valid)
        quality.append(np.where(mask[-1], rng.uniform(0, 1, SLOTS), 0.0))
    return (np.asarray(pts1, np.float32), np.asarray(pts2, np.float32),
            np.asarray(mask), np.asarray(quality, np.float32))


def _tcfg(robust=None, refine=None):
    return tcfg.PoseConfig(
        robust=tcfg.RobustConfig(**dict(ROBUST, **(robust or {}))),
        refine=tcfg.RefinementConfig(**dict(SYN_REFINE, **(refine or {}))))


@pytest.fixture(scope="module")
def synthetic_vs_jax():
    """(b)'s pairs through the JAX package, as ``jax.vmap(estimate_pose)``
    and as its single-pair calls under the same keys; the port's streams
    from those keys."""
    p1, p2, m, q = _synthetic()
    P = len(PAIRS)
    key = jax.random.PRNGKey(3)
    jcfg_pose = jcfg.PoseConfig(
        robust=jcfg.RobustConfig(**ROBUST),
        refine=jcfg.RefinementConfig(**SYN_REFINE))
    Kj, dj = jnp.asarray(KS), jnp.zeros(5)

    def one(a, b, c, d, k):
        return jp.estimate_pose(a, b, c, d, Kj, Kj, dj, dj, jcfg_pose, k)

    keys = jax.random.split(key, P)
    jin = [jnp.asarray(a) for a in (p1, p2, m, q)]
    jpose = jax.vmap(one)(*jin, keys)
    single = jax.jit(one)
    jsingles = [single(*(a[i] for a in jin), keys[i]) for i in range(P)]
    U, D = jax_pair_streams(key, P, _tcfg().robust)
    return (p1, p2, m, q), jpose, jsingles, (U, D)


def _pose_args(cfg):
    return (t(KS), t(KS), torch.zeros(5), torch.zeros(5), cfg)


def test_batched_estimate_pose_matches_jax_vmap(synthetic_vs_jax):
    (p1, p2, m, q), jpose, _, (U, D) = synthetic_vs_jax
    tpose = tp.estimate_pose(t(p1), t(p2), torch.from_numpy(m), t(q),
                             *_pose_args(_tcfg()), uniforms=U,
                             degen_uniforms=D)
    # the pairs leave the robust loop at different batches
    generated = n(tpose.n_models_generated)
    assert len(set(generated.tolist())) > 1, generated
    for i in range(len(PAIRS)):
        _check_pose_vs_jax(tpose, jpose, i)


def _first(pose):
    """A single pair's pose as a batch of one (the fields the checks
    read)."""
    return {f: getattr(pose, f)[None]
            for f in ("R", "t", "inlier_mask", *COUNTERS)}


@pytest.mark.parametrize("i", range(len(PAIRS)))
def test_single_pair_counters_match_jax(synthetic_vs_jax, i):
    """The bars of ``_check_counters_vs_jax`` already hold, and are
    needed, without a pair axis: the port's single-pair ``estimate_pose``
    against the JAX package's, and the JAX package's own vmap against its
    single-pair call (its solver's f32 root near-ties fall differently
    under ``vmap``)."""
    (p1, p2, m, q), jpose, jsingles, (U, D) = synthetic_vs_jax
    tpose = tp.estimate_pose(t(p1[i]), t(p2[i]), torch.from_numpy(m[i]),
                             t(q[i]), *_pose_args(_tcfg()), uniforms=U[i],
                             degen_uniforms=D[i])
    jsingle = SimpleNamespace(**_first(jsingles[i]))
    _check_pose_vs_jax(SimpleNamespace(**_first(tpose)), jsingle, 0)
    _check_counters_vs_jax(_counters(jpose, i), _counters(jsingle, 0))


# ---------------------------------------------------------------------------
# (c) run_batch against run on each pair
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("P", [3, 1])
@pytest.mark.parametrize("streams", ["explicit", "generator"])
def test_run_batch_matches_run_per_pair(P, streams):
    imgs1, imgs2, K, _, _ = _scenes(SEEDS[:P])
    pipe = _pipe()
    args = (t(K), t(K), torch.zeros(5), torch.zeros(5))
    if streams == "explicit":
        U, D = jax_pair_streams(jax.random.PRNGKey(1), P, pipe.pose_cfg.robust)
        corr, pose = pipe.run_batch(imgs1, imgs2, *args, uniforms=U,
                                    degen_uniforms=D)
        singles = [pipe.run(imgs1[i], imgs2[i], *args, uniforms=U[i],
                            degen_uniforms=D[i]) for i in range(P)]
    else:
        corr, pose = pipe.run_batch(imgs1, imgs2, *args,
                                    torch.Generator().manual_seed(4))
        gen = torch.Generator().manual_seed(4)
        singles = [pipe.run(imgs1[i], imgs2[i], *args, gen)
                   for i in range(P)]
    for i, (c, p) in enumerate(singles):
        assert_pair_equal(corr, pose, c, p, i)


@pytest.mark.parametrize("kind, match", [("SIFT", dict(gms_filter=True)),
                                         ("SURF", {})])
def test_run_batch_float_configs_match_run_per_pair(kind, match):
    """The scale-space detectors and float descriptors in run_batch:
    detection and matching pair by pair, the same pairs as run."""
    imgs1, imgs2, K, _, _ = _scenes(SEEDS[:2])
    pipe = tp.StereoPipeline(
        tcfg.DetectorConfig(kind=kind, max_keypoints=512),
        tcfg.DescriptorConfig(kind=kind), tcfg.MatchingConfig(**match),
        tcfg.PoseConfig(robust=tcfg.RobustConfig(**ROBUST)), device="cpu")
    args = (t(K), t(K), torch.zeros(5), torch.zeros(5))
    U, D = jax_pair_streams(jax.random.PRNGKey(2), 2, pipe.pose_cfg.robust)
    corr, pose = pipe.run_batch(imgs1, imgs2, *args, uniforms=U,
                                degen_uniforms=D)
    for i in range(2):
        c, p = pipe.run(imgs1[i], imgs2[i], *args, uniforms=U[i],
                        degen_uniforms=D[i])
        assert_pair_equal(corr, pose, c, p, i)


# ---------------------------------------------------------------------------
# (d) the flag options of the default branch, batched vs per pair
# ---------------------------------------------------------------------------

OPTIONS = {
    "prosac_off": dict(robust=dict(prosac=False)),
    "ransac": dict(robust=dict(estimator=tcfg.PoseEstimator.RANSAC)),
    "arrsac": dict(robust=dict(estimator=tcfg.PoseEstimator.ARRSAC)),
    "lo_off": dict(robust=dict(lo_refine=False)),
    "degeneracy_off": dict(robust=dict(check_degeneracy=False)),
    "eight_pt": dict(robust=dict(solver=tcfg.MinimalSolver.EIGHT_PT)),
    "torr": dict(refine=dict(weights=tcfg.RefineWeights.TORR)),
    "squared": dict(refine=dict(weights=tcfg.RefineWeights.SQUARED)),
    "refine_off": dict(refine=dict(enabled=False)),
    "polish_off": dict(refine=dict(polish_rt=False)),
    "no_refine_cap": dict(refine=dict(refine_max_points=None)),
}


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_pose_options_batched_match_per_pair(option):
    p1, p2, m, q = (torch.from_numpy(a) for a in _synthetic())
    cfg = _tcfg(**OPTIONS[option])
    e_shape, d_shape = trob.sample_shapes(cfg.robust)
    g = torch.Generator().manual_seed(9)
    U = torch.rand((len(PAIRS), *e_shape), generator=g)
    D = torch.rand((len(PAIRS), *d_shape), generator=g)
    args = _pose_args(cfg)
    with HostSyncs.traced() as log:
        pose = tp.estimate_pose(p1, p2, m, q, *args, uniforms=U,
                                degen_uniforms=D)
    alone = []
    for i in range(len(PAIRS)):
        with HostSyncs.traced() as log_i:
            p = tp.estimate_pose(p1[i], p2[i], m[i], q[i], *args,
                                 uniforms=U[i], degen_uniforms=D[i])
        assert_pose_equal(pose, p, i)
        alone.append(loop_iterations(log_i))
    # one host read per iteration of each run of each loop, which runs to
    # its slowest pair
    runs = {k for a in alone for k in a}
    assert loop_iterations(log) == {k: max(a.get(k, 0) for a in alone)
                                    for k in runs}


# ---------------------------------------------------------------------------
# (e) what raises
# ---------------------------------------------------------------------------


# (branch changes, stream, its wrong shape for P pairs): AutoTh's and
# Halign's streams with another branch's shape, or another P; a stream
# the branch does not take, at any shape
BAD_STREAMS = {
    "default_planes": (dict(), "plane_uniforms",
                       lambda P, e, d, pl: (P, *pl)),
    "halign_degen": (dict(use_halign=True), "degen_uniforms",
                     lambda P, e, d, pl: (P, *d)),
    "auto_th_uniforms": (dict(auto_th=True), "uniforms",
                         lambda P, e, d, pl: (P, *e)),
    "auto_th_degen": (dict(auto_th=True), "degen_uniforms",
                      lambda P, e, d, pl: (P + 1, *d)),
    "halign_planes": (dict(use_halign=True), "plane_uniforms",
                      lambda P, e, d, pl: (P, *pl[1:])),
    "halign_uniforms": (dict(use_halign=True), "uniforms",
                        lambda P, e, d, pl: (P, 3, *e)),
}


@pytest.mark.parametrize("case", sorted(BAD_STREAMS))
def test_pair_axis_stream_shapes_raise(case):
    """A new pair-axis stream of the wrong shape, or a stream the branch
    does not take, raises ValueError in estimate_pose and in run_batch
    before any work: no host read, no stage charged."""
    change, stream, shape = BAD_STREAMS[case]
    imgs1, imgs2, K, _, _ = _scenes(SEEDS[:2], 64, 128)
    pipe = _pipe(dataclasses.replace(_tcfg(), **change))
    cfg = pipe.pose_cfg
    e_shape, d_shape = trob.sample_shapes(cfg.robust)
    pl_shape = (cfg.halign.max_planes, *e_shape[:2], 4)
    p1, p2, m, q = (torch.from_numpy(a) for a in _synthetic())
    P = m.shape[0]
    with HostSyncs.traced() as log:
        with pytest.raises(ValueError, match=stream):
            tp.estimate_pose(p1, p2, m, q, t(KS), t(KS), torch.zeros(5),
                             torch.zeros(5), cfg, **{stream: torch.rand(
                                 shape(P, e_shape, d_shape, pl_shape))})
        with pytest.raises(ValueError, match=stream):
            pipe.run_batch(imgs1, imgs2, K, K, np.zeros(5), np.zeros(5),
                           **{stream: torch.rand(
                               shape(2, e_shape, d_shape, pl_shape))})
    assert log == [] and pipe.timer.times_ms == {}


def test_inconsistent_shapes_raise():
    imgs1, imgs2, K, _, _ = _scenes(SEEDS[:2], 64, 128)
    pipe = _pipe()
    args = (K, K, np.zeros(5), np.zeros(5))
    e_shape, d_shape = trob.sample_shapes(pipe.pose_cfg.robust)
    for a, b, kw in (
            (imgs1, imgs2[:1], {}),
            (imgs1[0], imgs2[0], {}),
            (imgs1, imgs2, dict(uniforms=torch.rand(3, *e_shape))),
            (imgs1, imgs2, dict(degen_uniforms=torch.rand(2, *e_shape)))):
        with pytest.raises(ValueError):
            pipe.run_batch(a, b, *args, **kw)
    p1, p2, m, q = (torch.from_numpy(a) for a in _synthetic())
    for bad in (dict(pts2=p2[:3]), dict(quality=q[:, :10])):
        kw = dict(pts1=p1, pts2=p2, mask=m, quality=q) | bad
        with pytest.raises(ValueError):
            tp.estimate_pose(**kw, K1=t(KS), K2=t(KS), dist1=torch.zeros(5),
                             dist2=torch.zeros(5), cfg=_tcfg())


def test_run_batch_on_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    imgs1, imgs2, K, _, _ = _scenes(SEEDS[:2], 64, 128)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _pipe(device="cuda").run_batch(imgs1, imgs2, K, K, np.zeros(5),
                                       np.zeros(5))


# ---------------------------------------------------------------------------
# (f) the LM polish's closed-form Jacobian
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch", [(), (3,)])
@pytest.mark.parametrize("rotation_only", [False, True])
def test_lm_jacobian_matches_jacfwd(batch, rotation_only):
    """_signed_sampson_jacobian is the derivative of the residual of
    _new_pose's pose at 0, in float64."""
    from torch.func import jacfwd

    g = torch.Generator().manual_seed(2)
    dt = torch.float64
    R = trf._exp_so3(0.1 * torch.randn(batch + (3,), generator=g, dtype=dt))
    tt = torch.nn.functional.normalize(
        torch.randn(batch + (3,), generator=g, dtype=dt), dim=-1)
    x1 = 0.3 * torch.randn(batch + (40, 2), generator=g, dtype=dt)
    x2 = x1 + 0.01 * torch.randn(batch + (40, 2), generator=g, dtype=dt)
    inv_s = torch.full(batch + (1,), 300.0, dtype=dt)
    B = None if rotation_only else trf._t_basis(tt)
    r, J = trf._signed_sampson_jacobian(R, tt, B, x1, x2, inv_s)
    ndof = 3 if rotation_only else 5

    def residual(p, R, tt, B, x1, x2, inv_s):
        return trf._signed_sampson(*trf._new_pose(R, tt, B, p), x1, x2,
                                   inv_s)[0]

    args = (R, tt, B, x1, x2, inv_s)
    p0 = torch.zeros(ndof, dtype=dt)
    if batch:
        want = torch.stack([
            jacfwd(residual)(p0, *(None if a is None else a[i]
                                   for a in args)) for i in range(batch[0])])
        want_r = torch.stack([residual(p0, *(None if a is None else a[i]
                                             for a in args))
                              for i in range(batch[0])])
    else:
        want, want_r = jacfwd(residual)(p0, *args), residual(p0, *args)
    assert J.shape == batch + (40, ndof)
    torch.testing.assert_close(J, want, rtol=1e-9, atol=1e-9)
    torch.testing.assert_close(r, want_r, rtol=1e-12, atol=1e-12)
