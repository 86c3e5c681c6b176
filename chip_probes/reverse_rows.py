"""``sharded_match``'s cross-check on the card: the reverse search over
the rows the merged matches name, held to the exhaustive reverse over
every map row, in a world of one over NCCL.

    python3 chip_probes/reverse_rows.py [--seed N]

Binary: 2048 queries of 8 words against 4,194,304 seeded rows (half the
queries noisy copies of map rows, an eighth exact copies of other
queries, ~5% of the query and map slots invalid). Float: 2048 x 65,536
unit rows of 128 (half planted with 0.005 of noise, the same copies and
invalid slots). For each: every field of every row equal to the
exhaustive formula (the kernel over all map rows in reverse, read at the
named rows) computed on the card; the call once under
``torch.cuda.set_sync_debug_mode("error")``; launches, collectives,
collective bytes and ``knn.reverse_rows`` per call; device ms per call of
the call's kernels and of the exhaustive formula's (torch.profiler).
Prints one JSON line with the card's name and power limit; exits
non-zero on a failed check. Needs one card.
"""

from __future__ import annotations

import argparse
import datetime
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402

BIG = 1e9
N_Q, ROWS, WORDS = 2048, 4_194_304, 8
F_ROWS, DEPTH = 65_536, 128


def _exhaustive(torch, search, q, db, vq, vdb, ratio):
    """One shard's match with the reverse over every row of `db`."""
    d1, d2, idx = search(q, db, vdb)
    d1 = torch.where(vq, d1, BIG)
    d2 = torch.where(vq, d2, BIG)
    best = torch.where(vq, idx.clamp(min=0), 0)
    col = search(db, q, vq)[2].clamp(min=0)
    keep = (vq & (d1 < BIG * 0.5) & (d1 < ratio * d2)
            & (col[best.long()] == torch.arange(q.shape[0],
                                                device=q.device)))
    return {"idx": best, "distance": d1, "second_distance": d2,
            "mask": keep}


def _inputs(torch, g, dev, binary):
    n_rows = ROWS if binary else F_ROWS
    if binary:
        db = torch.randint(-2**31, 2**31 - 1, (n_rows, WORDS), generator=g,
                           device=dev, dtype=torch.int32)
        q = torch.randint(-2**31, 2**31 - 1, (N_Q, WORDS), generator=g,
                          device=dev, dtype=torch.int32)
    else:
        db = cs._unit_rows(torch, g, n_rows, DEPTH, dev)
        q = cs._unit_rows(torch, g, N_Q, DEPTH, dev)
    rows = torch.randint(0, n_rows, (N_Q // 2,), generator=g, device=dev)
    if binary:
        flips = torch.randint(-2**31, 2**31 - 1, (N_Q // 2, WORDS),
                              generator=g, device=dev, dtype=torch.int32)
        keep = torch.randint(-2**31, 2**31 - 1, (N_Q // 2, WORDS),
                             generator=g, device=dev, dtype=torch.int32)
        q[:N_Q // 2] = db[rows] ^ (flips & keep & (keep >> 3))
    else:
        noisy = torch.abs(db[rows] + 0.005 * torch.randn(
            (N_Q // 2, DEPTH), generator=g, device=dev))
        q[:N_Q // 2] = noisy / torch.linalg.norm(noisy, dim=1, keepdim=True)
    q[-N_Q // 8:] = q[:N_Q // 8]
    vq = torch.rand(N_Q, generator=g, device=dev) >= 0.05
    vdb = torch.rand(n_rows, generator=g, device=dev) >= 0.05
    return q.contiguous(), db.contiguous(), vq, vdb


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        print("reverse_rows: no CUDA device", file=sys.stderr)
        return 2
    from matchinglib_poselib_torch.config import LOWE_RATIO
    from matchinglib_poselib_torch.ops.kernels import knn2
    from matchinglib_poselib_torch.parallel import mesh as pmesh
    from matchinglib_poselib_torch.parallel.matching import sharded_match
    from matchinglib_poselib_torch.utils import profiling

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    rec, fails = {"card": cs._nvidia_smi()}, []
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{cs._free_port()}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=300))
    try:
        mesh = pmesh.make_mesh(1, device=dev)
        g = torch.Generator(device=dev).manual_seed(args.seed + 2200)
        for kind in ("binary", "float"):
            binary = kind == "binary"
            search = knn2.knn2 if binary else knn2.knn2_l2
            kname = "knn2" if binary else "knn2_l2"
            q, db, vq, vdb = _inputs(torch, g, dev, binary)

            def call():
                return sharded_match(mesh, q, db, vq, vdb, binary=binary)

            def exhaustive():
                return _exhaustive(torch, search, q, db, vq, vdb,
                                   LOWE_RATIO)

            got, want = call(), exhaustive()
            r = {"shape": [N_Q, db.shape[0], db.shape[1]
                           * (32 if binary else 1)]}
            for k in ("idx", "distance", "second_distance", "mask"):
                a, b = getattr(got, k), want[k].to(getattr(got, k).dtype)
                r[f"{k}_differing"] = int((a != b).sum())
                if r[f"{k}_differing"]:
                    fails.append(f"{kind}: {k} differs from the exhaustive "
                                 f"reverse in {r[f'{k}_differing']} rows")
            r["kept"] = int(got.mask.sum())
            r["dropped_by_cross_check"] = int(
                (vq & (want["distance"] < LOWE_RATIO
                       * want["second_distance"]) & ~want["mask"]).sum())
            torch.cuda.synchronize()
            profiling.reset()
            torch.cuda.set_sync_debug_mode("error")
            try:
                call()
                r["sync_debug"] = "no host sync"
            except RuntimeError as e:
                r["sync_debug"] = str(e).splitlines()[0][:200]
                fails.append(f"{kind}: a host sync in sharded_match")
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            c = profiling.counters()
            r["counters"] = {k: c.get(k, 0) for k in (
                f"{kname}.launches", "collectives", "collective_bytes",
                "knn.reverse_rows")}
            want_c = {f"{kname}.launches": 2, "collectives": 2,
                      "collective_bytes": 4 * 4 * N_Q,
                      "knn.reverse_rows": N_Q}
            if r["counters"] != want_c:
                fails.append(f"{kind}: counters {r['counters']}, expected "
                             f"{want_c}")
            for name, fn in (("call", call), ("exhaustive", exhaustive)):
                ms, ops = cs._device_profile(torch, fn, iters=5, name="knn2")
                r[f"{name}_kernel_device_ms"] = ms
                r[f"{name}_kernels_per_call"] = ops
            named = db.index_select(0, got.idx.long())
            ms, _ = cs._device_profile(
                torch, lambda: search(named, q, vq), iters=10, name="knn2")
            r["named_reverse_launch_device_ms"] = ms
            rec[kind] = r
    finally:
        dist.destroy_process_group()
    rec["failures"] = fails
    print(json.dumps({"reverse_rows": rec}), flush=True)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
