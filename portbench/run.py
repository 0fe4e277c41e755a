#!/usr/bin/env python3
"""The benchmark of `repro_torch` on one NVIDIA GPU (written for an H100).

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of `BENCHMARK.json` from the root of a checkout and prints, as
its last line, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device`` and, traced, ``breakdown``; then
``setup_parts`` and, last, ``compared``: each number the comparison judged
beside its limit, which are also the last lines of standard error.

Exits non-zero, printing no result, without a CUDA device (or with fewer
than the cell asks for), when the program cannot be imported, and when
``jax``, ``jaxlib``, ``flax`` or ``repro`` was loaded once the window closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    sys.path[:0] = [str(CHECKOUT), str(CHECKOUT / "src")]
    from portbench import harness

    cell = harness.resolve(harness.load_json(CHECKOUT / "BENCHMARK.json"),
                           args.workload)
    os.environ.update(harness.cache_env())
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() is {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              device="cuda", t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}", file=sys.stderr)
        return 3
    harness.print_compared(result)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
