"""Print the port's experiment tables: the dry run's cells, the roofline and
the benchmarks.  The port of the JAX package's `launch/report.py`; it only
prints (``EXPERIMENTS.md`` is the reference's and is never written here).

  python -m repro_torch.launch.report [--section dryrun|roofline|bench]

Reads ``experiments/torch_dryrun/*.json`` (`launch/dryrun.py`) and
``experiments/benchmarks/torch_*.json``.  A key a record lacks prints as
``—``: the port's dry run counts no compile time, compiler temp bytes or
collectives.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.configs.base import LONG_CONTEXT_ARCHS, all_arch_names
from repro_torch.launch.roofline import dash, load_all, markdown_table

EXP = os.path.join(os.path.dirname(__file__), "..", "..", "..", "experiments")


def _gb(x):
    return None if x is None else x / 1e9


def dryrun_table() -> str:
    rows = []
    for path in sorted(glob.glob(os.path.join(EXP, "torch_dryrun", "*.json"))):
        with open(path) as f:
            r = json.load(f)
        coll = r.get("collectives")
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
            f"{dash(r.get('compile_s'), '.1f')} | "
            f"{dash(_gb(r.get('param_bytes')), '.2f')} | "
            f"{dash(_gb(r.get('memory', {}).get('temp_size_in_bytes')), '.2f')} | "
            f"{'—' if coll is None else sum(v['count'] for v in coll.values())} | "
            f"{'—' if coll is None else dash(_gb(sum(v['bytes'] for v in coll.values())), '.2f')} |"
        )
    head = (
        "| arch | shape | mesh | compile (s) | params (GB, global) | "
        "XLA temp/dev (GB) | #coll ops | coll bytes/dev (GB, sans-scan) |\n"
        "|---|---|---|---|---|---|---|---|"
    )
    return head + "\n" + "\n".join(rows)


def skipped_cells() -> str:
    out = []
    for arch in all_arch_names():
        if arch not in LONG_CONTEXT_ARCHS:
            out.append(f"  * {arch} × long_500k — pure full-attention arch (see DESIGN.md)")
    return "\n".join(out)


def roofline_table() -> str:
    return markdown_table(load_all())


def bench_summary() -> str:
    out = []
    for p in sorted(glob.glob(os.path.join(EXP, "benchmarks", "torch_*.json"))):
        name = os.path.basename(p)[: -len(".json")]
        with open(p) as f:
            out.append(f"### {name}\n```json\n{json.dumps(json.load(f), indent=1)}\n```")
    return "\n\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--section", default="all")
    args = ap.parse_args(argv)
    if args.section in ("dryrun", "all"):
        print("## Dry-run cells\n")
        print(dryrun_table())
        print("\nSkipped (documented):\n" + skipped_cells())
    if args.section in ("roofline", "all"):
        print("\n## Roofline\n")
        print(roofline_table())
    if args.section in ("bench", "all"):
        print("\n## Benchmarks\n")
        print(bench_summary())


if __name__ == "__main__":
    main()
