"""Serve a small model with batched requests + LZ4 KV-cache offload, on the port.

  PYTHONPATH=src python examples/torch_serve_lm.py                 # on the card
  PYTHONPATH=src python examples/torch_serve_lm.py --device cpu

The port's twin of `examples/serve_lm.py`: gemma2-9b at `.reduced()` with
seeded random weights answers six requests through `ServingEngine`; then a
session's KV cache is offloaded through `LZ4Engine` (the write kernels on
the card) and restored with `decode_to_device` (the read kernels), bit for
bit.
"""
import argparse

import numpy as np
import torch

from repro_torch import LZ4DecodeEngine, LZ4Engine
from repro_torch.configs.base import get_config
from repro_torch.distributed.sharding import single_device_mesh, use_mesh
from repro_torch.models import lm
from repro_torch.serving.engine import Request, ServingEngine, offload_cache, restore_cache


def leaves(tree) -> list:
    """The tensors of a cache tree (dicts in sorted key order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [] if tree is None else [tree]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the hand kernels) or cpu (their plain versions)")
    device = torch.device(ap.parse_args(argv).device)
    cfg = get_config("gemma2-9b").reduced()
    rng = np.random.default_rng(0)
    with use_mesh(single_device_mesh(device)):
        params = lm.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                                device=device)
        engine = ServingEngine(cfg, params, max_batch=4, cache_len=128, device=device)
        for uid in range(6):
            engine.add_request(Request(
                uid=uid,
                prompt=rng.integers(0, cfg.vocab_size, int(rng.integers(5, 20))).tolist(),
                max_new_tokens=8,
            ))
        done = engine.run()
        for r in done:
            print(f"req {r.uid}: {len(r.prompt)} prompt tokens -> {r.output}")

        # pause a session: LZ4-offload its KV cache, restore bit-exactly
        tokens = torch.tensor([done[0].prompt + done[0].output], dtype=torch.int32,
                              device=device)
        cache, _ = lm.prefill(params, {"tokens": tokens}, cfg, 128)
        blob, stats = offload_cache(cache, engine=LZ4Engine(device=device))
        restored = restore_cache(blob, decode_engine=LZ4DecodeEngine(device=device),
                                 to_device=True)
        got, want = leaves(restored), leaves(cache)
        ok = len(got) == len(want) and all(
            a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)
            for a, b in zip(want, got))
        print(f"KV offload: {stats['raw']} -> {stats['compressed']} bytes "
              f"(ratio {stats['ratio']:.2f}), bit-exact restore: {ok}")
        if not ok:
            raise SystemExit("the restored KV cache differs from the offloaded one")


if __name__ == "__main__":
    main()
