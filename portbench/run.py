"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Builds or loads the port's kernels (``matchinglib_poselib_torch/_build/``),
makes the cell's inputs on the card from the seed, warms up the cell's
shapes, runs requests back to back for ``--seconds``, then (``--trace 1``)
profiles a few more, checks the window's answers against the plain
reference, and prints one JSON line last on standard output: the cell's
end-to-end metrics (``--trace 0``) or its per-layer metrics (``--trace
1``). The numbers compared and their limits are the last lines on
standard error and the line's last key. Exits non-zero, printing no
result, without as many cards as the cell asks for, or if JAX or the JAX
package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
CACHE = ROOT / "portbench" / ".cache"
# every compile cache at a fixed place inside the checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(CACHE / sub)
# one host thread for PyTorch's CPU ops: the load of one process with few
# threads, so that the host's pace stays steady
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[var] = "1"
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import harness

    bench = harness.benchmark()
    chips = harness.find_cell(args.workload, bench).entry["chips"]

    t0 = time.perf_counter()
    import torch

    t1 = time.perf_counter()
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s), "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    print(f"setup_s harness {t0 - T_START:.4f} torch {t1 - t0:.4f} "
          f"card {time.perf_counter() - t1:.4f}", file=sys.stderr, flush=True)
    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), torch.device("cuda", 0),
                           t_start=T_START, bench=bench)
    found = harness.loaded_forbidden()
    if found:
        print(f"portbench: loaded {', '.join(found)}; the benchmark may not",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
