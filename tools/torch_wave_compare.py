#!/usr/bin/env python3
"""Time the `decode_wave` CUDA kernel of two checkouts on the same inputs.

    python3 tools/torch_wave_compare.py --base DIR [--seed N] [--iters N]

DIR is another checkout of this repo (for example a parent commit unpacked
with `git archive` into the git-ignored `build/`).  The script runs the
base, this checkout, this checkout and the base again, each in a process of
its own that imports `repro_torch` from that checkout (and builds its
kernels into that checkout's `build/`), so both kernels run on the same card
in one call and a drift of the card shows as a gap between the two runs of
one checkout.  Needs one CUDA device and `nvcc`.

Inputs, made from `--seed` on the card, at K = 65536 entries per block and
B = 65536 payload bytes, `rounds` = 16, M = 8, 32 and 64 blocks:

  random  ptr uniform in [0, K): cycles and forward pointers, so no round
          reaches a fixed point and all 16 run; most hops cross CTAs.
  zeros   the all-zero block's RLE chain, ptr[k] = max(k - 1, 0), lit_blk
          0: depth 65535, so all 16 rounds run, and in the late rounds the
          hops are 2^r entries long and cross CTAs.

Each worker checks every output against the plain version
(`decode_wave_plain`) and prints one JSON line: per input, the profiler's
device ms per launch (`device_ms`) and the CUDA-event ms per call (`ms`).
The script prints the card's name and power limit, one table, and as its
last line a JSON object with every run; it exits 1 if any output differs.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parents[1]
K = 65536
B = 65536
ROUNDS = 16
MS = (8, 32, 64)
KINDS = ("random", "zeros")


def inputs(kind: str, m: int, seed: int, dev: str = "cuda"):
    rng = np.random.default_rng(seed)
    blocks = rng.integers(0, 256, (m, B), np.uint8)
    k = np.arange(K)
    if kind == "random":
        lit = rng.integers(0, B, (m, K))
        ptr = rng.integers(0, K, (m, K))
    else:
        blocks[:] = 0
        lit = np.zeros((m, K), np.int64)
        ptr = np.broadcast_to(np.maximum(k - 1, 0), (m, K))
    total = np.full(m, K)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)  # noqa: E731
    return torch.from_numpy(blocks).to(dev), t(lit), t(ptr), t(total)


def device_ms(fn, iters: int, kernel: str = "decode_wave") -> float | str:
    """Mean device time of one `<kernel>_kernel` launch over `iters` calls
    of `fn`, from the profiler's device rows."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us, count = 0.0, 0
    for ev in prof.key_averages():
        if f"{kernel}_kernel" in ev.key:
            us += getattr(ev, "self_device_time_total", None) or \
                getattr(ev, "self_cuda_time_total", 0)
            count += ev.count
    return us / 1e3 / count if count and us > 0 else "not measured"


def event_ms(fn, iters: int) -> float:
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def worker(root: Path, seed: int, iters: int) -> dict:
    sys.path.insert(0, str(root / "src"))
    from repro_torch.kernels import decode_wave as kw

    assert Path(kw.__file__).resolve().is_relative_to(root.resolve()), kw.__file__
    res = {"checkout": str(root), "ok": True, "runs": []}
    for m in MS:
        for kind in KINDS:
            args = (*inputs(kind, m, seed + m), ROUNDS)
            out = kw.decode_wave(*args)
            torch.cuda.synchronize()
            same = torch.equal(out, kw.decode_wave_plain(*args))
            res["ok"] &= same
            run = lambda: kw.decode_wave(*args)  # noqa: E731
            for _ in range(3):
                run()
            torch.cuda.synchronize()
            res["runs"].append(dict(M=m, kind=kind, equal_plain=same,
                                    device_ms=device_ms(run, iters),
                                    ms=event_ms(run, iters)))
    return res


def run_checkouts(script: Path, base: Path, args: list[str]) -> tuple[str, list[dict]]:
    """The card's name and power limit, and the JSON line of `script
    --worker DIR args` for the base, this checkout, this checkout and the
    base again, each in a process of its own.  Raises RuntimeError if a
    worker fails."""
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.pop("REPRO_TORCH_BUILD_DIR", None)
    order = [("base", base), ("this", HERE), ("this", HERE), ("base", base)]
    results = []
    for label, root in order:
        p = subprocess.run([sys.executable, str(script), "--worker", str(root), *args],
                           capture_output=True, text=True, env=env, timeout=900)
        if p.returncode != 0:
            raise RuntimeError(f"{label} worker failed:\n{p.stdout[-4000:]}\n{p.stderr[-4000:]}")
        results.append(dict(label=label, **json.loads(p.stdout.strip().splitlines()[-1])))
    return card, results


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", type=Path, help="the other checkout")
    ap.add_argument("--seed", type=int, default=15)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.worker is not None:
        print(json.dumps(worker(a.worker, a.seed, a.iters)))
        return 0
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    if a.base is None or not (a.base / "src" / "repro_torch").is_dir():
        print("--base must name a checkout with src/repro_torch", file=sys.stderr)
        return 1
    card, results = run_checkouts(Path(__file__), a.base,
                                  ["--seed", str(a.seed), "--iters", str(a.iters)])
    print(card)
    print("M   kind    " + "  ".join(f"{r['label']:>9}" for r in results) + "  (device ms)")
    for i, run in enumerate(results[0]["runs"]):
        cells = [r["runs"][i]["device_ms"] for r in results]
        print(f"{run['M']:<3} {run['kind']:<7} " + "  ".join(
            f"{c:9.5f}" if isinstance(c, float) else f"{c:>9}" for c in cells))
    ok = all(r["ok"] for r in results)
    print(json.dumps({"ok": ok, "card": card, "K": K, "B": B, "rounds": ROUNDS,
                      "seed": a.seed, "iters": a.iters, "results": results}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
