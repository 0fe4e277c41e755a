#!/usr/bin/env python3
"""Time the `crc32` and `match_extend` CUDA kernels of two checkouts on the
same inputs, and probe the read path with wide caps (ROADMAP C2).

    python3 tools/torch_kernel_compare.py --base DIR [--seed N] [--iters N]

DIR is another checkout of this repo (for example a parent commit unpacked
with `git archive` into the git-ignored `build/`).  The script runs the
base, this checkout, this checkout and the base again, each in a process of
its own that imports `repro_torch` from that checkout (and builds its
kernels into that checkout's `build/`), so both checkouts' kernels run on the
same card in one call and a drift of the card shows as a gap between the two
runs of one checkout.  Needs one CUDA device and `nvcc`.

Inputs, made from `--seed` (the same in every worker):

  crc32 M=8, M=64   rows of 65,536 seeded bytes, n = 65,536 (the read path's
                    verified micro-batches at micro-batch 8 and 64)
  crc32 long        one row of 64 MiB + 5 seeded bytes (the whole-object
                    trailer of a v5 frame); the same length of the 14-file
                    corpus repeated ("long text") and of zero bytes ("long
                    zeros"), whose table lookups meet no bank conflicts
  match_extend M=32 the staged path's own inputs (`staged_candidates`,
                    "scatter", engine defaults) for 27 adversarial and 5
                    corpus blocks, max_match 36 (`chip_smoke.py`'s timing
                    inputs)
  wide caps         a 1 MiB frame written by the card through
                    `LZ4DecodeEngine(device="cuda")` with
                    `DevicePlanCaps(blk_cap=98304)` (on-device planning) and
                    `DevicePlanCaps(out_cap=131072)` (both planners): the
                    outcome, bytes equal or the exception raised

Each worker checks every kernel output against the plain version and prints
one JSON line: per input, the profiler's device ms per launch
(`device_ms`).  The script prints the card's name and power limit, one
table, and as its last line a JSON object with every run; it exits 1 if any
output differs from its plain version.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

from torch_wave_compare import device_ms, run_checkouts

MAX_BLOCK = 65536
LONG_ROW = (64 << 20) + 5


def staged_inputs(seed: int):
    """match_extend's inputs on the staged path: 27 adversarial + 5 corpus
    blocks, zeros past n (as `chip_smoke.kernel_blocks(32)`)."""
    from repro_torch.core import compressor
    from repro_torch.core.compressor import _PAD
    from repro_torch.core.corpus import adversarial_blocks, corpus_files

    blocks = list(adversarial_blocks().values())
    base = b"".join(corpus_files().values())
    i = 0
    while len(blocks) < 32:
        blocks.append(base[i: i + MAX_BLOCK])
        i += MAX_BLOCK
    stack = np.zeros((32, MAX_BLOCK + _PAD), np.uint8)
    ns = np.zeros((32,), np.int32)
    for j, b in enumerate(blocks[:32]):
        stack[j, : len(b)] = np.frombuffer(b, np.uint8)
        ns[j] = len(b)
    b_dev, n_dev = torch.from_numpy(stack).cuda(), torch.from_numpy(ns).cuda()
    block, cand, valid = compressor.staged_candidates(b_dev, n_dev, "scatter", 8, 8)
    return block, cand, valid, n_dev


def wide_caps_probe(seed: int) -> list:
    """The read path with caps wider than the default: outcome per case."""
    from repro_torch import LZ4DecodeEngine, LZ4Engine
    from repro_torch.core.decode_plan import DevicePlanCaps

    rng = np.random.default_rng(seed)
    data = (b"wide caps probe " * 40000 + rng.integers(0, 256, 1 << 19, np.uint8).tobytes())[: 1 << 20]
    frame = LZ4Engine(device="cuda").compress(data)
    out = []
    for caps, pod in ((DevicePlanCaps(blk_cap=98304), True),
                      (DevicePlanCaps(out_cap=131072), False),
                      (DevicePlanCaps(out_cap=131072), True)):
        try:
            got = LZ4DecodeEngine(device="cuda", plan_on_device=pod, caps=caps).decode(frame)
            outcome = "equal" if got == data else "bytes differ"
        except Exception as e:  # noqa: BLE001 - the probe records what the checkout does
            outcome = f"{type(e).__name__}: {e}"
        out.append(dict(blk_cap=caps.blk_cap, out_cap=caps.out_cap,
                        plan_on_device=pod, outcome=outcome))
    return out


def worker(root: Path, seed: int, iters: int) -> dict:
    sys.path.insert(0, str(root / "src"))
    from repro_torch.kernels import crc32 as kc
    from repro_torch.kernels import match_extend as ke

    assert Path(kc.__file__).resolve().is_relative_to(root.resolve()), kc.__file__
    res = {"checkout": str(root), "ok": True, "runs": []}
    rng = np.random.default_rng(seed)

    def run(name, kernel, fn, plain):
        got = fn()
        torch.cuda.synchronize()
        same = torch.equal(got, plain())
        res["ok"] &= same
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        res["runs"].append(dict(case=name, equal_plain=same,
                                device_ms=device_ms(fn, iters, kernel)))

    for m in (8, 64):
        d = torch.from_numpy(rng.integers(0, 256, (m, MAX_BLOCK), np.uint8)).cuda()
        n = torch.full((m,), MAX_BLOCK, dtype=torch.int32, device="cuda")
        run(f"crc32 M={m}", "crc32", lambda: kc.crc32(d, n), lambda: kc.crc32_plain(d, n))
    from repro_torch.core.corpus import corpus_files

    text = np.frombuffer(b"".join(corpus_files().values()), np.uint8)
    nl = torch.tensor([LONG_ROW], dtype=torch.int32, device="cuda")
    for kind, arr in (("", rng.integers(0, 256, LONG_ROW, np.uint8)),
                      (" text", np.tile(text, -(-LONG_ROW // text.size))[:LONG_ROW]),
                      (" zeros", np.zeros(LONG_ROW, np.uint8))):
        row = torch.from_numpy(np.ascontiguousarray(arr)).cuda()[None]
        run("crc32 long" + kind, "crc32", lambda: kc.crc32(row, nl), lambda: kc.crc32_plain(row, nl))
    block, cand, valid, ns = staged_inputs(seed)
    run("match_extend M=32", "match_extend", lambda: ke.match_extend(block, cand, valid, ns, 36),
        lambda: ke.match_extend_plain(block, cand, valid, ns, 36))
    res["wide_caps"] = wide_caps_probe(seed)
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", type=Path, help="the other checkout")
    ap.add_argument("--seed", type=int, default=16)
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
    print(f"{'case':<18}" + "  ".join(f"{r['label']:>9}" for r in results) + "  (device ms)")
    for i, run in enumerate(results[0]["runs"]):
        cells = [r["runs"][i]["device_ms"] for r in results]
        print(f"{run['case']:<18}" + "  ".join(
            f"{c:9.5f}" if isinstance(c, float) else f"{c:>9}" for c in cells))
    for r in results:
        print(r["label"], "wide caps:", [w["outcome"][:60] for w in r["wide_caps"]])
    ok = all(r["ok"] for r in results)
    print(json.dumps({"ok": ok, "card": card, "seed": a.seed, "iters": a.iters,
                      "results": results}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
