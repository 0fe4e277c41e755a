#!/usr/bin/env python3
"""Where a full-width decode step of the port's serving path spends its time.

    python3 tools/torch_decode_profile.py [--steps N] [--turns N]

Draws qwen3-1.7b at full width on the card (float32 weights, bfloat16
compute, as `chip_smoke.py`'s `serve_full`), prefills 4 x 24 tokens into a
256-slot cache, then times greedy `decode_step`s in turns: float32 weights
(cast to bfloat16 inside every call, as the reference does) and the same
weights cast once beforehand.  Each variant is then traced by
`torch.profiler` over 4 steps: device busy ms and device ops per step,
CUDA launch calls per step and their mean host µs, and the host operators
with the most self time.  Needs one CUDA device; prints the card's name
and power limit, then one JSON line.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

if not torch.cuda.is_available():
    sys.exit("torch_decode_profile.py: needs a CUDA device")

import chip_smoke as smoke  # noqa: E402
from repro_torch._tree import tree_map  # noqa: E402
from repro_torch.models import lm  # noqa: E402


def traced(params, cache, cfg, steps: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    smoke.decode_ms(params, cache, cfg, steps=2)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        smoke.decode_ms(params, cache, cfg, steps=steps)   # a warm-up + `steps` timed
    n = 2 * steps
    rows = prof.key_averages()
    dev = [r for r in rows if r.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(getattr(r, "self_device_time_total", None) or r.self_cuda_time_total
               for r in dev) / 1e3
    host = sorted((r for r in rows if r.device_type != torch.autograd.DeviceType.CUDA),
                  key=lambda r: -r.self_cpu_time_total)
    launch = [r for r in host if r.key in ("cudaLaunchKernel", "cuLaunchKernelEx")]
    calls = sum(r.count for r in launch)
    return dict(steps_traced=n, device_busy_ms_per_step=busy / n,
                device_ops_per_step=sum(r.count for r in dev) / n,
                launch_calls_per_step=calls / n,
                launch_host_us_mean=sum(r.self_cpu_time_total for r in launch) / max(calls, 1),
                host_self_ms_per_step=sum(r.self_cpu_time_total for r in host) / 1e3 / n,
                top_host=[dict(op=r.key, self_ms_per_step=r.self_cpu_time_total / 1e3 / n,
                               calls_per_step=r.count / n) for r in host[:8]])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--turns", type=int, default=3)
    args = ap.parse_args(argv)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    cfg = smoke.serve_config()
    dev = torch.device("cuda")
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(smoke.SEED + 63),
                            device=dev)
    bf16 = tree_map(lambda t: t.to(torch.bfloat16) if t.is_floating_point() else t, params)
    cache, _ = lm.prefill(params, smoke.make_batch(smoke.SEED, cfg, 4, 24, device=dev),
                          cfg, 256)
    turns = {"float32": [], "bfloat16": []}
    for _ in range(args.turns):
        for name, w in (("float32", params), ("bfloat16", bf16)):
            turns[name].append(smoke.decode_ms(w, cache, cfg, steps=args.steps))
    print(card, flush=True)
    print(json.dumps({
        "arch": cfg.name, "batch": 4, "cache_len": 256, "steps": args.steps,
        "ms_per_step_turns": turns,
        "ms_per_step_median": {k: float(np.median(v)) for k, v in turns.items()},
        "traced": {"float32": traced(params, cache, cfg, 4),
                   "bfloat16": traced(bf16, cache, cfg, 4)}}), flush=True)


if __name__ == "__main__":
    main()
