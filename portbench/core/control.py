"""Readings for the limits of a cell's check, on the card:

    python3 -m portbench.core.control --workload <cell> --seeds 1 2 3 \\
        [--program SECONDS]

For each seed, the numbers of the control (the configuration's reference
in the precision just below the configuration's, put in the program's
place) and, with ``--program``, those of a run of the program of that
many seconds, all in this one process.  One JSON line a reading.  The
benchmark's own runs never run this; ``tests/test_portbench_card.py``
holds the control to the limits."""

import argparse
import json
import sys
import time

from portbench.core import harness, spec


def control_numbers(name, seed, devices, overrides=None):
    cell = spec.Cell(name, overrides=overrides)
    entry = cell.entry_module().Entry(cell, seed, devices)
    return entry.control(cell.reference())


def failed(numbers, limits):
    return sorted(k for k, v in numbers.items() if not v <= limits[k])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", type=float, default=0.0)
    args = ap.parse_args(argv)
    harness.cache_env()
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    cell = spec.Cell(args.workload)
    limits = cell.limits()
    for seed in args.seeds:
        t0 = time.perf_counter()
        nums = control_numbers(args.workload, seed,
                               [torch.device("cuda", 0)] * cell.chips)
        print(json.dumps({"side": "control", "seed": seed, "numbers": nums,
                          "fails": failed(nums, limits),
                          "seconds": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()
    if args.program:
        devices = [torch.device("cuda", i) for i in range(cell.chips)]
        for seed in args.seeds:
            res = harness.run(args.workload, seed, args.program, False,
                              devices=devices, t_start=time.perf_counter())
            nums = {k: c["value"] for k, c in res["checks"].items()}
            print(json.dumps({"side": "program", "seed": seed,
                              "numbers": nums, "fails": failed(nums, limits),
                              "metrics": res["metrics"]}), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
