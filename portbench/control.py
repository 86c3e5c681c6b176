"""Readings of a cell's correctness check, for setting its limits.

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...] \
        [--requests N]

For each seed: the cell's set-up at its own size, N requests of the
program (as many as the check samples from, at least), then the check
twice on the same sample: the program's answers (the lower readings) and
the control's, the reference put in the program's place in the lower
precision or with the broken guarantee that the cell's generator names
(the upper readings). One JSON line per seed. The benchmark's runs do not
run this; it needs the cards the cell asks for.
"""

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--requests", type=int, default=None)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness

    cell = harness.find_cell(args.workload)
    if not torch.cuda.is_available():
        print("portbench: control readings need a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    params = cell.spec["params"]
    n = args.requests or params["control_requests"]
    seconds = harness.benchmark()["run_seconds"]  # the cell's own size
    for seed in args.seeds:
        t0 = time.perf_counter()
        driver = cell.generator.Driver(cell.config, params, seed, dev,
                                       seconds)
        driver.warm()
        first = params["warm_requests"]
        for i in range(first, first + n):
            driver.request(i)
        driver.free_program()
        program = driver.check(cell.spec["limits"])
        control = driver.check(cell.spec["limits"], control=True)
        driver.close()
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "program": program, "control": control,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
