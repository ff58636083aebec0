#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print one JSON line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Runs from the root of a checkout, on the GPUs of the machine it starts on
(the cell's ``chips`` of them).  Exits non-zero, printing no result, where
there is no CUDA device or fewer than the cell needs, where the program or
a cell's file is missing, or where jax, jaxlib, flax or the JAX package
was loaded in this process.  See portbench/README.md."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench.core import harness, spec  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    harness.cache_env()
    try:
        cell = spec.Cell(args.workload)
    except (spec.SpecError, KeyError) as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("portbench: no CUDA device", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} GPUs, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 3
    devices = [torch.device("cuda", i) for i in range(cell.chips)]
    try:
        result = harness.run(args.workload, args.seed, args.seconds,
                             bool(args.trace), devices=devices,
                             t_start=T_START)
    except harness.ForbiddenModules as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return 5
    except Exception:
        traceback.print_exc()
        print("portbench: the run failed", file=sys.stderr)
        return 4
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
