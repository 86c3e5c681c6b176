"""One rank of a gloo world on the CPU for tests/test_torch_parallel.py.

    python tests/torch_parallel_worker.py <rank> <world> <store> <inputs.npz> <out_dir>

Imports torch and numpy only (never jax): it joins the world through a
FileStore, builds the meshes of its world (world 4: 2 x 2, 1 x 4 and
4 x 1; world 1: 1 x 1), runs the port's distributed functions on the
seeded inputs of ``binary_case``, ``float_case``, ``ba_case`` and
``consensus_case`` (and on the golden stream poses of <inputs.npz>),
``sharded_match`` on ``reverse_case`` at every ``FLAGS`` setting, and
writes every output to <out_dir>/rank<r>.npz; ``spans_case`` adds the
profiler's trace of one ``sharded_match`` per mesh as
<out_dir>/rank<r>_<mesh>_trace.json. The test process builds the
same inputs from the same functions for the JAX package.
"""

from __future__ import annotations

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the meshes each world builds: label -> db_parallelism
MESHES = {4: {"2x2": 2, "1x4": 4, "4x1": 1}, 1: {"1x1": 1}}
N_Q, N_DB, WORDS = 64, 256, 8
N_QF, N_DBF, DEPTH = 32, 128, 128
BA_POINTS, BA_ITERATIONS = 256, 8
FRAMES = 16
# sharded_match's spans, outermost first, the parts in their order
SPANS = ("knn.sharded_match", "knn.forward", "knn.merge", "knn.reverse")
# sharded_match's (ratio_test, cross_check) settings in reverse_case
FLAGS = ((True, True), (True, False), (False, True), (False, False))


def binary_case(layout_shards: int, seed: int = 7):
    """64 queries x 256 db rows of 8 uint32 words: every query's exact
    partner planted at a random row (across the shards), 8 of them twice
    (a distance-0 tie between two rows), ~10% of the query and db slots
    invalid, and db shard 1 of `layout_shards` wholly invalid (its planted
    partners lost)."""
    rng = np.random.default_rng(seed)
    dq = rng.integers(0, 2**32, size=(N_Q, WORDS), dtype=np.uint32)
    ddb = rng.integers(0, 2**32, size=(N_DB, WORDS), dtype=np.uint32)
    pos = rng.permutation(N_DB)
    ddb[pos[:N_Q]] = dq
    ddb[pos[N_Q:N_Q + 8]] = dq[:8]
    vq = rng.random(N_Q) > 0.1
    vdb = rng.random(N_DB) > 0.1
    rows = N_DB // layout_shards
    vdb[rows:2 * rows] = False
    return dq, ddb, vq, vdb


def float_case(seed: int = 8):
    """32 queries x 128 db rows of 128 floats, every row of unit norm as
    SIFT's are: each query's noisy partner (0.01 before the norm) planted
    at a random row, ~10% of the slots invalid."""
    rng = np.random.default_rng(seed)
    dq = rng.normal(size=(N_QF, DEPTH))
    ddb = rng.normal(size=(N_DBF, DEPTH))
    pos = rng.permutation(N_DBF)[:N_QF]
    ddb[pos] = dq + rng.normal(scale=0.01, size=dq.shape)

    def unit(a):
        return (a / np.linalg.norm(a, axis=1, keepdims=True)).astype(
            np.float32)
    return unit(dq), unit(ddb), rng.random(N_QF) > 0.1, rng.random(N_DBF) > 0.1


def reverse_case(binary: bool, layout_shards: int, seed: int = 9):
    """The cross-check's hard cases, binary (N_Q x N_DB x WORDS) or float
    (N_QF x N_DBF x DEPTH, unit rows): the last eighth of the queries
    exact copies of the first (a tie in the reverse search: the copy
    loses, but for query 0, invalid, whose copy wins), the eighth before them near copies of the second eighth (a
    few bits, or 0.02 of noise: two queries naming one row), partners
    planted for the first half of the queries, a sixteenth of them twice
    (a tie between two map rows), ~10% of the query and map slots
    invalid, and map shard 1 of `layout_shards` wholly invalid."""
    rng = np.random.default_rng(seed)
    nq, ndb = (N_Q, N_DB) if binary else (N_QF, N_DBF)
    e = nq // 8
    if binary:
        dq = rng.integers(0, 2**32, size=(nq, WORDS), dtype=np.uint32)
        bit = np.uint32(1) << rng.integers(0, 32, size=(e, WORDS),
                                           dtype=np.uint32)
        dq[-2 * e:-e] = dq[e:2 * e] ^ np.where(
            rng.random((e, WORDS)) < 0.3, bit, np.uint32(0))
        ddb = rng.integers(0, 2**32, size=(ndb, WORDS), dtype=np.uint32)
    else:
        def unit(a):
            return (a / np.linalg.norm(a, axis=1, keepdims=True)).astype(
                np.float32)
        dq = rng.normal(size=(nq, DEPTH))
        dq[-2 * e:-e] = dq[e:2 * e] + rng.normal(scale=0.02,
                                                 size=(e, DEPTH))
        dq = unit(dq)
        ddb = unit(rng.normal(size=(ndb, DEPTH)))
    dq[-e:] = dq[:e]
    pos = rng.permutation(ndb)
    half = nq // 2
    ddb[pos[:half]] = dq[:half] if binary else unit(
        dq[:half] + rng.normal(scale=0.01, size=(half, DEPTH)))
    ddb[pos[half:half + e // 2]] = ddb[pos[:e // 2]]
    vq = rng.random(nq) > 0.1
    # query 0 invalid, its copy valid: the copy wins its row's reverse
    vq[0], vq[nq - e] = False, True
    vdb = rng.random(ndb) > 0.1
    rows = ndb // layout_shards
    vdb[rows:2 * rows] = False
    if binary:
        dq, ddb = dq.view(np.int32), ddb.view(np.int32)
    return dq, ddb, vq, vdb


def _rodrigues(axis, ang):
    a = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    Kx = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return np.eye(3) + np.sin(ang) * Kx + (1 - np.cos(ang)) * (Kx @ Kx)


def ba_case(n: int = BA_POINTS, seed: int = 42):
    """tests/test_parallel.py::test_sharded_ba_matches_local's problem: 256
    points at depths 4-10 seen by two 500 px cameras (0.2 px noise), the
    second camera's rotation perturbed by exp([0.004, -0.006, 0.003]) and
    the points by 0.01; camera 0 fixed. Returns the keyword arguments of
    ``bundle_adjust`` (float32 arrays) but the iteration count."""
    rng = np.random.default_rng(seed)
    axis = rng.normal(size=3)
    R = _rodrigues(axis, np.deg2rad(rng.uniform(2.0, 12.0)))
    t = rng.normal(size=3)
    t /= np.linalg.norm(t)
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                  rng.uniform(4, 10, n)], axis=1)
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
    obs = np.zeros((n, 2, 2))
    for c, (Rc, tc) in enumerate([(np.eye(3), np.zeros(3)), (R, t)]):
        Xc = X @ Rc.T + tc
        obs[:, c] = (Xc[:, :2] / Xc[:, 2:3]) @ K[:2, :2].T + K[:2, 2]
    obs += rng.normal(scale=0.2, size=obs.shape)
    w = np.array([0.004, -0.006, 0.003])
    R0 = R @ _rodrigues(w, np.linalg.norm(w))
    X0 = X + rng.normal(scale=0.01, size=X.shape)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return dict(obs=f32(obs), vis=np.ones((n, 2), np.float32),
                R=f32(np.stack([np.eye(3), R0])),
                t=f32(np.stack([np.zeros(3), t])), K=f32(np.stack([K, K])),
                dist=np.zeros((2, 5), np.float32), X=f32(X0),
                free_cams=np.array([0.0, 1.0], np.float32))


def consensus_case(seed: int = 3):
    """tests/multihost_worker.py's 16 frames: a planted 5 deg rig pose,
    each frame's rotation jittered by up to 0.2 deg and its translation by
    1e-3, weights 50-200. Returns (R (16, 3, 3), t (16, 3), w (16,)
    float32, R_gt, t_gt)."""
    rng = np.random.default_rng(seed)
    R_gt = _rodrigues([0.3, 1.0, -0.2], np.deg2rad(5.0))
    t_gt = np.array([0.8, -0.1, 0.2])
    t_gt /= np.linalg.norm(t_gt)
    Rs, ts, ws = [], [], []
    for _ in range(FRAMES):
        Rs.append(_rodrigues(rng.normal(size=3),
                             np.deg2rad(rng.uniform(0, 0.2))) @ R_gt)
        ts.append(t_gt + rng.normal(scale=1e-3, size=3))
        ws.append(rng.uniform(50, 200))
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return f32(Rs), f32(ts), f32(ws), R_gt, t_gt


def _match_out(out, key, res):
    for name in ("idx", "distance", "second_distance", "mask"):
        out[f"{key}/{name}"] = getattr(res, name).numpy()


def trace_path(out_dir, rank: int, label: str) -> str:
    return os.path.join(out_dir, f"rank{rank}_{label}_trace.json")


def spans_case(m, label: str, args, out: dict, out_dir, rank: int):
    """One binary ``sharded_match`` with the profiler off, with
    ``torch.profiler.record_function`` and ``torch.cuda.Event`` replaced by
    fakes that note each call (the calls it made, the spans and the
    counters it left), then one under the profiler (CPU activity: each
    span's count and whether its device time is None; the trace)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from matchinglib_poselib_torch.parallel.matching import sharded_match
    from matchinglib_poselib_torch.utils import profiling

    made = []
    real = torch.profiler.record_function, torch.cuda.Event

    def noting(fn):
        def call(*a, **k):
            made.append(fn)
            return fn(*a, **k)
        return call
    profiling.reset()
    torch.profiler.record_function, torch.cuda.Event = map(noting, real)
    try:
        off = sharded_match(m, *args)
    finally:
        torch.profiler.record_function, torch.cuda.Event = real
    key = f"{label}/spans"
    counts = profiling.counters()
    out[f"{key}/off_calls"] = np.array(len(made))
    out[f"{key}/off_spans"] = np.array(len(profiling.span_totals()))
    out[f"{key}/collectives"] = np.array(counts.get("collectives", 0))
    out[f"{key}/collective_bytes"] = np.array(
        counts.get("collective_bytes", 0))
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = sharded_match(m, *args)
    prof.export_chrome_trace(trace_path(out_dir, rank, label))
    totals = profiling.span_totals()
    out[f"{key}/counts"] = np.array([totals.get(n, {}).get("count", 0)
                                     for n in SPANS])
    out[f"{key}/device_ms_none"] = np.array(
        [n in totals and totals[n]["device_ms"] is None for n in SPANS])
    _match_out(out, f"{key}/off", off)
    _match_out(out, f"{key}/on", on)


def reverse_layout(n_db: int) -> int:
    """The shards reverse_case lays out for a mesh of `n_db` db ranks:
    its own, or quarters where the map is one block."""
    return n_db if n_db > 1 else 4


def reverse_cases(m, label: str, out: dict):
    """``sharded_match`` on reverse_case's binary and float inputs at every
    FLAGS setting: each call's outputs, and the counters it left
    (collectives, collective_bytes, knn.reverse_rows)."""
    import torch

    from matchinglib_poselib_torch.parallel import mesh as pmesh
    from matchinglib_poselib_torch.parallel.matching import sharded_match
    from matchinglib_poselib_torch.utils import profiling

    layout = reverse_layout(pmesh.axis_size(m, pmesh.DB_AXIS))
    for kind in ("binary", "float"):
        q, db, vq, vdb = (torch.as_tensor(a) for a in
                          reverse_case(kind == "binary", layout))
        args = (q, pmesh.db_block(m, db), vq, pmesh.db_block(m, vdb))
        for ratio_test, cross_check in FLAGS:
            key = f"{label}/reverse/{kind}/{int(ratio_test)}{int(cross_check)}"
            profiling.reset()
            _match_out(out, key, sharded_match(
                m, *args, binary=kind == "binary", ratio_test=ratio_test,
                cross_check=cross_check))
            counts = profiling.counters()
            for name in ("collectives", "collective_bytes",
                         "knn.reverse_rows"):
                out[f"{key}/{name}"] = np.array(counts.get(name, -1))


def _run(rank: int, world: int, store: str, inputs: str, out_dir: str):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    from matchinglib_poselib_torch.ops import ba
    from matchinglib_poselib_torch.parallel import mesh as pmesh
    from matchinglib_poselib_torch.parallel import stream
    from matchinglib_poselib_torch.parallel.ba import bundle_adjust_sharded
    from matchinglib_poselib_torch.parallel.matching import sharded_match

    gold = np.load(inputs)
    out = {}
    ba_args = {k: torch.as_tensor(v) for k, v in ba_case().items()}
    for label, db in MESHES[world].items():
        m = pmesh.make_mesh(db, device="cpu")
        n_db = pmesh.axis_size(m, pmesh.DB_AXIS)
        out[f"{label}/coordinate"] = np.array(
            [pmesh.axis_index(m, pmesh.PAIRS_AXIS),
             pmesh.axis_index(m, pmesh.DB_AXIS)])
        dq, ddb, vq, vdb = binary_case(n_db if world > 1 else 4)
        binary = (torch.as_tensor(dq.view(np.int32)),
                  pmesh.db_block(m, torch.as_tensor(ddb.view(np.int32))),
                  torch.as_tensor(vq), pmesh.db_block(m, torch.as_tensor(vdb)))
        spans_case(m, label, binary, out, out_dir, rank)
        reverse_cases(m, label, out)
        if label != "4x1":
            _match_out(out, f"{label}/binary", sharded_match(m, *binary))
            fq, fdb, fvq, fvdb = float_case()
            _match_out(out, f"{label}/float", sharded_match(
                m, torch.as_tensor(fq),
                pmesh.db_block(m, torch.as_tensor(fdb)),
                torch.as_tensor(fvq),
                pmesh.db_block(m, torch.as_tensor(fvdb)), binary=False))
            res = bundle_adjust_sharded(m, **ba_args,
                                        iterations=BA_ITERATIONS)
            for name, v in res._asdict().items():
                out[f"{label}/ba/{name}"] = v.numpy()
            if n_db > 1:  # a point count that does not divide db
                try:
                    bundle_adjust_sharded(
                        m, **{k: v[:-1] if k in ("obs", "vis", "X") else v
                              for k, v in ba_args.items()}, iterations=1)
                    out[f"{label}/ba_refused"] = np.array(False)
                except ValueError:
                    out[f"{label}/ba_refused"] = np.array(True)
        if label != "1x4":
            R, t, w, _, _ = consensus_case()
            for key, (Rf, tf, wf) in (
                    ("consensus", (R, t, w)),
                    ("golden", (gold["R"], gold["t"], gold["w"]))):
                R_ml, t_ml, wsum = stream.windowed_pose_consensus(
                    m, *(stream.frame_window_block(m, torch.as_tensor(a))
                         for a in (Rf, tf, wf)))
                out[f"{label}/{key}/R"] = R_ml.numpy()
                out[f"{label}/{key}/t"] = t_ml.numpy()
                out[f"{label}/{key}/wsum"] = wsum.numpy()
    local = ba.bundle_adjust(**ba_args, iterations=BA_ITERATIONS)
    for name, v in local._asdict().items():
        out[f"local/ba/{name}"] = v.numpy()
    if world == 1:
        grouped = ba.bundle_adjust(**ba_args, iterations=BA_ITERATIONS,
                                   group=dist.group.WORLD)
        for name, v in grouped._asdict().items():
            out[f"world_group/ba/{name}"] = v.numpy()
    else:
        from matchinglib_poselib_torch.entry import dryrun_multichip

        res = dryrun_multichip(device="cpu")
        for name in ("R", "t", "n_inliers", "n_matches", "match_mask",
                     "inlier_mask"):
            out[f"dryrun/{name}"] = getattr(res, name).numpy()
        out["dryrun/mesh_shape"] = np.array(res.mesh_shape)
    out["jax_imported"] = np.array(any(
        m == "jax" or m.startswith(("jax.", "matchinglib_poselib_tpu"))
        for m in sys.modules))
    dist.barrier()
    dist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    _run(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6])
