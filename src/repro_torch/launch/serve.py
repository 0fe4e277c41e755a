"""Serving entry point: batched requests against a (reduced) model.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b --requests 8
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.models import lm
from repro_torch.serving.engine import Request, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new-tokens", type=int, default=12)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).reduced()
    rng = np.random.default_rng(0)
    device = torch.device(args.device)
    params = lm.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                            device=device)
    engine = ServingEngine(cfg, params, max_batch=args.max_batch, device=device)
    for uid in range(args.requests):
        plen = int(rng.integers(4, 24))
        engine.add_request(Request(
            uid=uid,
            prompt=rng.integers(0, cfg.vocab_size, plen).tolist(),
            max_new_tokens=args.max_new_tokens,
        ))
    t0 = time.perf_counter()
    done = engine.run()
    dt = time.perf_counter() - t0
    total_new = sum(len(r.output) for r in done)
    print(f"[serve] {len(done)} requests, {total_new} tokens in {dt:.2f}s "
          f"({total_new/dt:.1f} tok/s)")
    for r in done[:3]:
        print(f"  req {r.uid}: prompt[{len(r.prompt)}] -> {r.output}")
    return done


if __name__ == "__main__":
    main()
