"""Compress any file with the port's batched LZ4Engine and verify the round trip.

  PYTHONPATH=src python examples/torch_compress_file.py [path] [--entries 256] [--micro-batch 32]
  PYTHONPATH=src python examples/torch_compress_file.py path --device cpu

The port's twin of `examples/compress_file.py`.  Without a path, compresses
the built-in corpus and prints per-file ratios (the paper's Table III
setting: combined scheme, 64 KB blocks).  Output is a self-describing
frame; the round trip goes through `LZ4DecodeEngine.decode` (what
`decode_frame` delegates to) with no out-of-band lengths.  Runs on the card
unless ``--device cpu``.
"""
import argparse
import time

import torch

from repro_torch import LZ4DecodeEngine, LZ4Engine
from repro_torch.core import corpus_files


def compress_report(engine: LZ4Engine, decoder: LZ4DecodeEngine, name: str, data: bytes):
    t0 = time.perf_counter()
    frame = engine.compress(data)
    dt = time.perf_counter() - t0
    restored = decoder.decode(frame)
    assert restored == data, f"round-trip failed for {name}!"
    s = engine.stats
    print(f"{name:>10}: {len(data):>8} -> {len(frame):>8} bytes "
          f"(ratio {len(data)/max(len(frame), 1):5.3f}) {len(data)/dt/1e6:6.2f} MB/s "
          f"[{s.blocks} blocks / {s.dispatches} dispatches"
          f"{f', {s.raw_blocks} raw' if s.raw_blocks else ''}]  round-trip OK")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("path", nargs="?")
    ap.add_argument("--entries", type=int, default=256)
    ap.add_argument("--micro-batch", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the hand kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    engine = LZ4Engine(hash_bits=args.entries.bit_length() - 1,
                       micro_batch=args.micro_batch, device=device)
    decoder = LZ4DecodeEngine(device=device)
    if args.path:
        with open(args.path, "rb") as f:
            data = f.read()
        compress_report(engine, decoder, args.path, data)
    else:
        for name, data in corpus_files().items():
            compress_report(engine, decoder, name, data)


if __name__ == "__main__":
    main()
