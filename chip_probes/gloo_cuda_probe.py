"""Which collectives gloo takes on CUDA tensors, and what a world on one
card can build, on one CUDA card.

    python3 chip_probes/gloo_cuda_probe.py

Spawns a gloo world of 2 ranks sharing cuda:0 and an NCCL world of 1 on
cuda:0 (FileStore rendezvous in a temporary directory). Each rank tries
``all_reduce`` (SUM) and ``all_gather_into_tensor`` on CUDA tensors, with
and without ``torch.cuda.set_sync_debug_mode("error")``, then builds a
("pairs", "db") ``DeviceMesh`` over the world and reduces over each of
its dimension groups. Prints one JSON line per rank: each check's outcome
("ok", "wrong" or the exception's first line).
"""

from __future__ import annotations

import json
import os
import sys
import tempfile


def _refusal(e: Exception) -> str:
    return f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"


def _try(fn):
    try:
        return "ok" if fn() else "wrong"
    except Exception as e:  # noqa: BLE001 -- the probe reports every refusal
        return _refusal(e)


def _rank(rank, world, backend, store_path, out):
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    torch.cuda.set_device(0)
    dist.init_process_group(backend, store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    dev = torch.device("cuda:0")
    res = {"rank": rank, "world": world, "backend": backend}

    def all_reduce():
        x = torch.full((1000,), float(rank + 1), device=dev)
        dist.all_reduce(x)
        return x, world * (world + 1) / 2

    def all_gather():
        x = torch.full((3, 4), float(rank), device=dev)
        y = torch.empty((3 * world, 4), device=dev)
        dist.all_gather_into_tensor(y, x)
        return y[:, 0], torch.arange(world, device=dev).repeat_interleave(3)

    for name, fn in (("all_reduce", all_reduce), ("all_gather", all_gather)):
        for debug in (0, "error"):
            # the collective alone under the sync-debug mode; the check
            # reads the host after the mode is off again
            torch.cuda.set_sync_debug_mode(debug)
            try:
                got, want = fn()
                outcome = None
            except Exception as e:  # noqa: BLE001 -- reported per check
                outcome = _refusal(e)
            torch.cuda.set_sync_debug_mode(0)
            if outcome is None:
                outcome = _try(lambda: bool((got == want).all()))
            res[name + ("_sync_debug" if debug else "")] = outcome

    def mesh():
        m = DeviceMesh("cuda", torch.arange(world).reshape(world, 1),
                       mesh_dim_names=("pairs", "db"))
        ok = True
        for d in ("pairs", "db"):
            x = torch.ones(2, device=dev)
            dist.all_reduce(x, group=m.get_group(d))
            ok &= bool((x == m.size(m.mesh_dim_names.index(d))).all())
        return ok

    res["device_mesh"] = _try(mesh)
    dist.barrier()
    dist.destroy_process_group()
    out.put(res)


def main() -> int:
    import torch
    import torch.multiprocessing as mp

    if not torch.cuda.is_available():
        print("gloo_cuda_probe: no CUDA device", file=sys.stderr)
        return 2
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "python": sys.version.split()[0],
                      "devices": torch.cuda.device_count()}))
    ctx = mp.get_context("spawn")
    ok = True
    for backend, world in (("gloo", 2), ("nccl", 1)):
        with tempfile.TemporaryDirectory() as d:
            out = ctx.Queue()
            procs = [ctx.Process(target=_rank, args=(
                r, world, backend, os.path.join(d, "store"), out))
                for r in range(world)]
            for p in procs:
                p.start()
            results = [out.get(timeout=120) for _ in procs]
            for p in procs:
                p.join(timeout=60)
                ok &= p.exitcode == 0
        for r in sorted(results, key=lambda r: r["rank"]):
            print(json.dumps(r))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
