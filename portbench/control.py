#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on one CUDA device.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 --seconds 3 [--mode sound|control|both|fault]

For each seed, one run of the cell in this process with a short window:
``sound`` as the benchmark runs it, ``control`` with the driver's control
switched on (the program with one guarantee of the configuration broken; see
the driver's docstring), ``fault`` under the driver's ``plant_fault`` (the
timed path broken underneath, where the driver has one).  One JSON line per
run: the mode, the seed, the numbers compared and ``correct``.  The
benchmark's own runs never run this.
"""
import argparse
import contextlib
import json
import os
import sys
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--mode", choices=("sound", "control", "both", "fault"),
                   default="both")
    args = p.parse_args(argv)
    sys.path[:0] = [str(CHECKOUT), str(CHECKOUT / "src")]
    from portbench import harness

    cell = harness.resolve(harness.load_json(CHECKOUT / "BENCHMARK.json"),
                           args.workload)
    os.environ.update(harness.cache_env())
    import torch

    if not torch.cuda.is_available():
        print("portbench control: no CUDA device", file=sys.stderr)
        return 2
    modes = ("sound", "control") if args.mode == "both" else (args.mode,)
    for seed in (int(s) for s in args.seeds.split(",")):
        for mode in modes:
            planted = (cell.driver.plant_fault() if mode == "fault"
                       else contextlib.nullcontext())
            with planted:
                r = harness.run_cell(cell, seed, args.seconds, False, device="cuda",
                                     control=mode == "control")
            print(json.dumps({"workload": args.workload, "mode": mode, "seed": seed,
                              "correct": r["correct"], "attempted": r["attempted"],
                              "compared": r["compared"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
