"""Distribution on torch.distributed (``matchinglib_poselib_torch/
parallel/`` and ``entry.dryrun_multichip``) against the JAX package's
``parallel/`` on the same meshes.

One module fixture runs two gloo worlds on the CPU once, each rank a
fresh interpreter that imports torch only (``torch_parallel_worker.py``,
FileStore rendezvous under the test's temporary directory, 120 s per
rank): a world of 4 that builds the 2 x 2, 1 x 4 and 4 x 1 meshes and runs
the dryrun, and a world of 1 (1 x 1). The JAX results come from
``make_mesh(jax.devices()[:n], db_parallelism)`` on the 8-device virtual
CPU mesh of ``tests/conftest.py``, so that the JAX shards are the port's
ranks block for block. Inputs are made with numpy from seeds
(``torch_parallel_worker.*_case``).

Bars:
- ``mesh_shape`` and the rank layout: equal to the JAX ``make_mesh``;
- binary ``sharded_match`` (64 x 256 x 8 words, planted partners and
  ties, ~10% invalid slots, one db shard wholly invalid): idx, distance,
  second_distance and mask equal to the JAX package's on every row, and
  every rank's equal to rank 0's; the world of 1 equal to the 1 x 4 mesh;
- float ``sharded_match`` (32 x 128 x 128): distances within 1e-5 (1 +
  |d|), idx equal where the gap exceeds that, masks equal outside rows
  near a tie of the ratio test or of the best candidate;
- ``sharded_match`` on ``reverse_case`` (copied and near-copied
  queries, duplicated rows, invalid slots, a wholly invalid shard),
  binary and float, with the ratio test and the cross-check on and off:
  every field of every row equal, on every rank, to the exhaustive
  reverse over the same shards (``exhaustive_sharded_match``); two
  all-gathers (4 (3 + 1) N1 S bytes) and N1 rows searched in reverse a
  call with the cross-check, one (4 3 N1 S bytes) and none without;
- ``bundle_adjust_sharded`` (256 points, 2 cameras, 8 iterations) against
  the JAX package's on the same mesh, and the port's against its own
  single-process result: R and t within 5e-4, points within 5e-3,
  final cost within rtol 1e-3 (the bars of tests/test_parallel.py for
  sharded against local: f32 reduction order over 8 LM steps); cameras
  bit-identical on every rank; at world 1 ``group=<world>`` bit-equal to
  ``group=None``;
- ``windowed_pose_consensus`` (16 frames): R and t within 1e-5 and the
  weight sum within 1e-6 relative of the JAX package's; within 0.3 / 0.5
  deg of the planted pose; over the port's own ``StereoRefine`` per-frame
  poses of 8 frames, within 0.2 / 1.0 deg of its most-likely pose;
- ``dryrun_multichip`` on the world of 4 passes its assertions, and each
  pair of its gathered batch equals the port's ``run_batch`` of the whole
  batch in one process: match and inlier masks and counts equal, R within
  0.01 deg, t within 0.05 deg.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from matchinglib_poselib_tpu.parallel import mesh as jmesh
from matchinglib_poselib_tpu.parallel import stream as jstream
from matchinglib_poselib_tpu.parallel.ba import (
    bundle_adjust_sharded as jax_ba_sharded,
)
from matchinglib_poselib_tpu.parallel.matching import (
    sharded_match as jax_sharded_match,
)

from matchinglib_poselib_torch import entry
from matchinglib_poselib_torch.config import (
    PoseConfig, RobustConfig, StereoRefineConfig,
)
from matchinglib_poselib_torch.models.stereo_refine import StereoRefine
from matchinglib_poselib_torch.parallel import mesh as tmesh

import torch_parallel_worker as worker
from test_torch_helpers import (
    dir_angle_deg, exhaustive_sharded_match, rot_chordal_deg,
)

RANK_TIMEOUT_S = 120
MATCH_FIELDS = ("idx", "distance", "second_distance", "mask")
FLOAT_TOL = 1e-5
BA_CAM_ATOL, BA_POINTS_ATOL, BA_COST_RTOL = 5e-4, 5e-3, 1e-3


def _golden_stream():
    """The port's StereoRefine on 8 frames of 256 correspondences of the
    consensus case's rig pose (tests/multihost_worker.py step 5): per-frame
    R, t and weights, and its most-likely pose."""
    rng = np.random.default_rng(5)
    _, _, _, R_gt, t_gt = worker.consensus_case()
    Kmat = np.array([[500.0, 0, 320.0], [0, 500.0, 240.0], [0, 0, 1.0]])
    sr = StereoRefine(Kmat, Kmat, cfg=StereoRefineConfig(
        max_pool_correspondences=2048, pose=PoseConfig(
            robust=RobustConfig(batch_hypotheses=64, max_batches=2))),
        seed=3, device="cpu")
    Rs, ts, ws = [], [], []
    n = 256
    for _ in range(8):
        X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                      rng.uniform(4, 12, n)], axis=1)
        X2 = X @ R_gt.T + t_gt
        p1 = (X / X[:, 2:3] @ Kmat.T)[:, :2] + rng.normal(scale=0.3,
                                                          size=(n, 2))
        p2 = (X2 / X2[:, 2:3] @ Kmat.T)[:, :2] + rng.normal(scale=0.3,
                                                            size=(n, 2))
        st = sr.add_new_correspondences(p1.astype(np.float32),
                                        p2.astype(np.float32))
        Rs.append(st.R)
        ts.append(st.t)
        ws.append(max(st.inlier_ratio, 1e-3) * n)
    assert sr.nr_estimation >= 7
    return dict(R=np.float32(Rs), t=np.float32(ts), w=np.float32(ws),
                R_ml=sr.R_most_likely, t_ml=sr.t_most_likely)


class _Worlds:
    """The two gloo worlds, started at once; ``ranks(world)`` waits for
    them (once) and returns each rank's outputs."""

    def __init__(self, tmp):
        self.gold = _golden_stream()
        inputs = str(tmp / "inputs.npz")
        np.savez(inputs, **self.gold)
        env = dict(os.environ, PYTHONPATH=worker.REPO, OMP_NUM_THREADS="1")
        env.pop("JAX_PLATFORMS", None)
        self.dirs, self.procs = {}, []
        for world in (4, 1):
            d = tmp / f"world{world}"
            d.mkdir()
            self.dirs[world] = d
            self.procs += [subprocess.Popen(
                [sys.executable, worker.__file__, str(r), str(world),
                 str(d / "store"), inputs, str(d)], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for r in range(world)]
        self.out = None

    def ranks(self, world):
        if self.out is None:
            logs = []
            try:
                for p in self.procs:
                    logs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
            finally:
                for p in self.procs:
                    p.kill()
            for p, log in zip(self.procs, logs):
                assert p.returncode == 0, log[-3000:]
            self.out = {w: [dict(np.load(d / f"rank{r}.npz"))
                            for r in range(w)]
                        for w, d in self.dirs.items()}
        return self.out[world]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    w = _Worlds(tmp_path_factory.mktemp("worlds"))
    yield w
    for p in w.procs:
        p.kill()


def _jax_mesh(label):
    """The JAX mesh of a label "<pairs>x<db>" over the first devices."""
    pairs, db = (int(x) for x in label.split("x"))
    return jmesh.make_mesh(jax.devices()[:pairs * db], db)


def _every_rank_equal(ranks, prefix):
    for r, out in enumerate(ranks[1:], 1):
        for k, v in ranks[0].items():
            if k.startswith(prefix):
                np.testing.assert_array_equal(out[k], v,
                                              err_msg=f"rank {r}: {k}")


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_shape_and_layout_match_jax(n):
    devices = jax.devices()[:n]
    for db in (None, 1, 2, 3, 4):
        jm = jmesh.make_mesh(devices, db)
        shape = tmesh.mesh_shape(n, db)
        assert shape == (jm.shape["pairs"], jm.shape["db"]), (n, db)
        # rank r sits at (r // db, r % db), as device r does in the JAX mesh
        layout = np.vectorize(lambda d: devices.index(d))(jm.devices)
        np.testing.assert_array_equal(
            layout, np.arange(n).reshape(shape))


def test_make_mesh_needs_a_world_and_a_card():
    with pytest.raises(RuntimeError, match="no process group"):
        tmesh.make_mesh(device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.make_mesh(device="cuda")
    with pytest.raises(ValueError):
        tmesh.mesh_shape(4, 0)


def test_worlds_never_import_jax(worlds):
    for world in (4, 1):
        for r, out in enumerate(worlds.ranks(world)):
            assert not out["jax_imported"], (world, r)
    coords = [tuple(out["2x2/coordinate"]) for out in worlds.ranks(4)]
    assert coords == [(0, 0), (0, 1), (1, 0), (1, 1)]
    coords = [tuple(out["1x4/coordinate"]) for out in worlds.ranks(4)]
    assert coords == [(0, 0), (0, 1), (0, 2), (0, 3)]


# ---------------------------------------------------------------------------
# pod-wide kNN
# ---------------------------------------------------------------------------


def _jax_match(label, binary):
    m = _jax_mesh(label)
    if binary:
        q, db, vq, vdb = worker.binary_case(m.shape["db"])
    else:
        q, db, vq, vdb = worker.float_case()
    res = jax.jit(lambda *a: jax_sharded_match(m, *a, binary=binary))(
        jnp.asarray(q), jnp.asarray(db), jnp.asarray(vq, jnp.float32),
        jnp.asarray(vdb, jnp.float32))
    return {k: np.asarray(getattr(res, k)) for k in MATCH_FIELDS}


@pytest.mark.parametrize("label", ["2x2", "1x4"])
def test_binary_sharded_match_equals_jax_on_every_row(worlds, label):
    want = _jax_match(label, True)
    ranks = worlds.ranks(4)
    for k in MATCH_FIELDS:
        np.testing.assert_array_equal(
            ranks[0][f"{label}/binary/{k}"], want[k].astype(
                ranks[0][f"{label}/binary/{k}"].dtype), err_msg=k)
    _every_rank_equal(ranks, f"{label}/binary/")
    # the cases plant what they claim: kept, lost and invalid rows
    _, _, vq, _ = worker.binary_case(int(label[-1]))
    assert want["mask"].sum() >= 20 and (~want["mask"] & vq).sum() >= 10
    assert (~vq).any()
    if label == "1x4":
        # the world of 1 on the same inputs
        one = worlds.ranks(1)[0]
        for k in MATCH_FIELDS:
            np.testing.assert_array_equal(one[f"1x1/binary/{k}"],
                                          ranks[0][f"1x4/binary/{k}"])


@pytest.mark.parametrize("label", ["2x2", "1x4", "1x1"])
def test_float_sharded_match_matches_jax(worlds, label):
    want = _jax_match("1x4" if label == "1x1" else label, False)
    out = worlds.ranks(1 if label == "1x1" else 4)
    got = {k: out[0][f"{label}/float/{k}"] for k in MATCH_FIELDS}
    tol = FLOAT_TOL * (1.0 + np.abs(want["distance"]))
    np.testing.assert_array_less(
        np.abs(got["distance"] - want["distance"]), tol + 1e-30)
    np.testing.assert_array_less(
        np.abs(got["second_distance"] - want["second_distance"]),
        FLOAT_TOL * (1.0 + np.abs(want["second_distance"])) + 1e-30)
    # an invalid query's row is the constant (1e9, 1e9, 0) on both sides
    _, _, vq, _ = worker.float_case()
    gap = want["second_distance"] - want["distance"]
    clear = (gap > tol) | ~vq
    np.testing.assert_array_equal(got["idx"][clear], want["idx"][clear])
    ratio_tie = np.abs(want["distance"] - 0.8 * want["second_distance"]) \
        <= tol
    keep = clear & ~ratio_tie
    np.testing.assert_array_equal(got["mask"][keep], want["mask"][keep])
    assert keep.mean() >= 0.9 and want["mask"].sum() >= 20
    _every_rank_equal(out, f"{label}/float/")


# ---------------------------------------------------------------------------
# sharded_match's spans and counters (utils/profiling)
# ---------------------------------------------------------------------------

SPAN_MESHES = ["2x2", "1x4", "4x1", "1x1"]


def _world(label):
    return 1 if label == "1x1" else 4


@pytest.mark.parametrize("label", SPAN_MESHES)
def test_sharded_match_spans_are_off_without_the_profiler(worlds, label):
    """No record_function, no CUDA event and no span without the
    profiler."""
    for r, out in enumerate(worlds.ranks(_world(label))):
        assert out[f"{label}/spans/off_calls"] == 0, r
        assert out[f"{label}/spans/off_spans"] == 0, r


@pytest.mark.parametrize("label", SPAN_MESHES)
def test_sharded_match_spans_nest_under_the_profiler(worlds, label):
    """Each span once per call, no device time on the CPU, and the
    trace's ranges of the three parts in order inside the whole call."""
    import json

    for r, out in enumerate(worlds.ranks(_world(label))):
        np.testing.assert_array_equal(out[f"{label}/spans/counts"],
                                      [1] * len(worker.SPANS))
        assert out[f"{label}/spans/device_ms_none"].all()
        with open(worker.trace_path(worlds.dirs[_world(label)], r,
                                    label)) as f:
            events = json.load(f)["traceEvents"]
        ranges = {e["name"]: (e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("cat") == "user_annotation"
                  and e["name"] in worker.SPANS}
        assert sorted(ranges) == sorted(worker.SPANS), r
        start, end = ranges[worker.SPANS[0]]
        last = start
        for name in worker.SPANS[1:]:
            a, b = ranges[name]
            assert last <= a <= b <= end, (r, name)
            last = b


@pytest.mark.parametrize("label", SPAN_MESHES)
def test_sharded_match_same_with_and_without_the_profiler(worlds, label):
    for r, out in enumerate(worlds.ranks(_world(label))):
        for k in MATCH_FIELDS:
            np.testing.assert_array_equal(out[f"{label}/spans/on/{k}"],
                                          out[f"{label}/spans/off/{k}"],
                                          err_msg=f"rank {r}: {k}")
            if label != "4x1":
                np.testing.assert_array_equal(
                    out[f"{label}/spans/on/{k}"],
                    out[f"{label}/binary/{k}"], err_msg=f"rank {r}: {k}")


@pytest.mark.parametrize("label", SPAN_MESHES)
def test_sharded_match_counts_collectives_and_bytes(worlds, label):
    """Two all-gathers a call, and the bytes each leaves on the rank: the
    (S, 3, N1) candidates and the (S, N1) best queries of the rows the
    matches name, int32."""
    shards = int(label.split("x")[1])
    want = 4 * (3 * worker.N_Q * shards + worker.N_Q * shards)
    for r, out in enumerate(worlds.ranks(_world(label))):
        assert out[f"{label}/spans/collectives"] == 2, r
        assert out[f"{label}/spans/collective_bytes"] == want, r
    if label == "4x1":
        # a rank of the world of 4 holding the whole map moves what the
        # world of 1 does
        assert want == worlds.ranks(1)[0]["1x1/spans/collective_bytes"]


@pytest.mark.parametrize("kind", ["binary", "float"])
@pytest.mark.parametrize("label", SPAN_MESHES)
def test_named_row_reverse_equals_the_exhaustive_reverse(worlds, label,
                                                         kind):
    """Every field of every row, on every rank and at every (ratio test,
    cross-check) setting, equal to the exhaustive reverse over the same
    shards in one process (``exhaustive_sharded_match``), on
    reverse_case's copies, near copies, duplicated rows, invalid slots
    and wholly invalid shard."""
    shards = int(label.split("x")[1])
    q, db, vq, vdb = (torch.as_tensor(a) for a in worker.reverse_case(
        kind == "binary", worker.reverse_layout(shards)))
    for ratio_test, cross_check in worker.FLAGS:
        key = f"{label}/reverse/{kind}/{int(ratio_test)}{int(cross_check)}"
        want = exhaustive_sharded_match(
            q, db, vq, vdb, shards, binary=kind == "binary",
            ratio_test=ratio_test, cross_check=cross_check)
        for r, out in enumerate(worlds.ranks(_world(label))):
            for k in MATCH_FIELDS:
                np.testing.assert_array_equal(
                    out[f"{key}/{k}"], want[k].numpy(),
                    err_msg=f"rank {r}: {key}/{k}")
        if cross_check:
            # the case reaches the cross-check: it drops matches the
            # forward pass and the ratio test keep
            loose = exhaustive_sharded_match(
                q, db, vq, vdb, shards, binary=kind == "binary",
                ratio_test=ratio_test, cross_check=False)["mask"]
            assert (loose & ~want["mask"]).sum() >= 2, key
            assert want["mask"].sum() >= 5, key


@pytest.mark.parametrize("label", SPAN_MESHES)
def test_cross_check_costs_one_collective_of_n1_ints(worlds, label):
    """With the cross-check a call makes two all-gathers, (S, 3, N1) and
    (S, N1) int32, and searches N1 rows in reverse; without it one
    all-gather and no reverse row."""
    shards = int(label.split("x")[1])
    for r, out in enumerate(worlds.ranks(_world(label))):
        for kind, n1 in (("binary", worker.N_Q), ("float", worker.N_QF)):
            for ratio_test, cross_check in worker.FLAGS:
                key = (f"{label}/reverse/{kind}/"
                       f"{int(ratio_test)}{int(cross_check)}")
                c = int(cross_check)
                assert out[f"{key}/collectives"] == 1 + c, (r, key)
                assert out[f"{key}/collective_bytes"] == \
                    4 * (3 + c) * n1 * shards, (r, key)
                assert out[f"{key}/knn.reverse_rows"] == c * n1, (r, key)


# ---------------------------------------------------------------------------
# point-sharded BA
# ---------------------------------------------------------------------------


def _ba_close(a, b, what):
    for k in ("R", "t"):
        np.testing.assert_allclose(a[k], b[k], atol=BA_CAM_ATOL,
                                   err_msg=f"{what}: {k}")
    np.testing.assert_allclose(a["points"], b["points"], atol=BA_POINTS_ATOL,
                               err_msg=f"{what}: points")
    np.testing.assert_allclose(a["final_cost"], b["final_cost"],
                               rtol=BA_COST_RTOL, err_msg=f"{what}: cost")


@pytest.mark.parametrize("label", ["2x2", "1x4", "1x1"])
def test_sharded_ba_matches_jax_and_local(worlds, label):
    out = worlds.ranks(1 if label == "1x1" else 4)
    got = {k: out[0][f"{label}/ba/{k}"] for k in
           ("R", "t", "points", "final_cost", "initial_cost")}
    local = {k: out[0][f"local/ba/{k}"] for k in ("R", "t", "points",
                                                  "final_cost")}
    if label != "1x1":
        m = _jax_mesh(label)
        res = jax.jit(lambda a: jax_ba_sharded(
            m, **a, iterations=worker.BA_ITERATIONS))(
                {k: jnp.asarray(v) for k, v in worker.ba_case().items()})
        _ba_close(got, {k: np.asarray(getattr(res, k))
                        for k in ("R", "t", "points", "final_cost")},
                  "port vs JAX package")
        assert out[0][f"{label}/ba_refused"]
    _ba_close(got, local, "sharded vs local")
    assert got["final_cost"] < got["initial_cost"]
    assert got["points"].shape == (worker.BA_POINTS, 3)
    # the cameras, costs and gathered points are the same bits everywhere
    _every_rank_equal(out, f"{label}/ba/")


def test_bundle_adjust_group_of_one_is_bit_equal(worlds):
    one = worlds.ranks(1)[0]
    for k in ("R", "t", "K", "dist", "points", "initial_cost", "final_cost",
              "n_iterations"):
        np.testing.assert_array_equal(one[f"world_group/ba/{k}"],
                                      one[f"local/ba/{k}"], err_msg=k)
        np.testing.assert_array_equal(one[f"1x1/ba/{k}"],
                                      one[f"local/ba/{k}"], err_msg=k)


# ---------------------------------------------------------------------------
# the frame-window consensus
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("label", ["2x2", "4x1", "1x1"])
def test_windowed_consensus_matches_jax(worlds, label):
    out = worlds.ranks(1 if label == "1x1" else 4)
    R, t, w, R_gt, t_gt = worker.consensus_case()
    m = _jax_mesh(label)
    jR, jt, jw = (np.asarray(a) for a in jax.jit(
        lambda *a: jstream.windowed_pose_consensus(m, *a))(
            jnp.asarray(R), jnp.asarray(t), jnp.asarray(w)))
    got = {k: out[0][f"{label}/consensus/{k}"] for k in ("R", "t", "wsum")}
    np.testing.assert_allclose(got["R"], jR, atol=1e-5)
    np.testing.assert_allclose(got["t"], jt, atol=1e-5)
    np.testing.assert_allclose(got["wsum"], jw, rtol=1e-6)
    assert rot_chordal_deg(got["R"], R_gt) < 0.3
    assert dir_angle_deg(got["t"], t_gt) < 0.5
    _every_rank_equal(out, f"{label}/consensus/")


@pytest.mark.parametrize("label", ["2x2", "4x1", "1x1"])
def test_stream_consensus_agrees_with_stereo_refine(worlds, label):
    out = worlds.ranks(1 if label == "1x1" else 4)
    R_ml = out[0][f"{label}/golden/R"]
    t_ml = out[0][f"{label}/golden/t"]
    assert rot_chordal_deg(R_ml, worlds.gold["R_ml"]) < 0.2
    assert dir_angle_deg(t_ml, worlds.gold["t_ml"]) < 1.0
    _every_rank_equal(out, f"{label}/golden/")


# ---------------------------------------------------------------------------
# the dryrun
# ---------------------------------------------------------------------------


def test_dryrun_multichip_equals_one_process_batch(worlds):
    ranks = worlds.ranks(4)
    np.testing.assert_array_equal(ranks[0]["dryrun/mesh_shape"], [2, 2])
    _every_rank_equal(ranks, "dryrun/")
    B = 4
    _, imgs1, imgs2, K, uni, degen = entry.dryrun_batch(B)
    corr, pose = entry.dryrun_pipeline("cpu").run_batch(
        imgs1, imgs2, K, K, torch.zeros(5), torch.zeros(5), uniforms=uni,
        degen_uniforms=degen)
    got = ranks[0]
    assert got["dryrun/R"].shape == (B, 3, 3)
    np.testing.assert_array_equal(got["dryrun/match_mask"],
                                  corr.mask.numpy())
    np.testing.assert_array_equal(got["dryrun/inlier_mask"],
                                  pose.inlier_mask.numpy())
    np.testing.assert_array_equal(got["dryrun/n_matches"], corr.n.numpy())
    np.testing.assert_array_equal(got["dryrun/n_inliers"],
                                  pose.n_inliers.numpy())
    for i in range(B):
        assert rot_chordal_deg(got["dryrun/R"][i], pose.R[i].numpy()) < 0.01
        if np.linalg.norm(pose.t[i].numpy()) > 0.5:
            assert dir_angle_deg(got["dryrun/t"][i], pose.t[i].numpy()) < 0.05
        else:
            np.testing.assert_allclose(got["dryrun/t"][i], pose.t[i].numpy(),
                                       atol=1e-6)
