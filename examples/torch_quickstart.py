"""Quickstart for the PyTorch/CUDA port: the LZ4-HT engine in five minutes.

  PYTHONPATH=src python examples/torch_quickstart.py                 # on the card
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu    # plain versions

The port's twin of `examples/quickstart.py`, section by section, through
`repro_torch`'s public names: the batched `LZ4Engine` (one dispatch of the
hand kernels per micro-batch, byte emission on the device, a
self-describing frame), the `device_emit` switch and the host transfer it
saves, the frame round trip, the decode engine (`LZ4DecodeEngine` +
seekable `FrameReader` random access, and a restore that stays in device
memory), the schemes (the paper's Tables I-III in miniature) and the
hardware cycle model (Table IV).  On the card the engines launch the CUDA
kernels of `src/repro_torch/csrc/`; with ``--device cpu`` they run the
kernels' plain PyTorch versions and write the same frames.

Deeper dives: docs/torch-port.md (the port's module map and kernels),
docs/frame-format.md (container spec).
"""
import argparse

import torch

from repro_torch import FrameReader, LZ4DecodeEngine, LZ4Engine, frame_info
from repro_torch.core import (
    compress_greedy,
    compress_windowed,
    decode_block,
    encode_block,
    plan_size,
)
from repro_torch.core.cycle_model import ours_throughput


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the hand kernels) or cpu (their plain versions)")
    device = torch.device(ap.parse_args(argv).device)
    decoder = LZ4DecodeEngine(device=device)

    # --- some compressible data ---------------------------------------------
    data = (b"the quick brown fox jumps over the lazy dog. " * 800)[:32768]

    # --- 1. the batched engine: frame in/out, one dispatch per micro-batch --
    engine = LZ4Engine(device=device)        # paper's combined scheme (S1+S2)
    frame = engine.compress(data)            # self-describing frame bytes
    assert decoder.decode(frame) == data     # no out-of-band lengths needed
    info = frame_info(frame)
    ratio = len(data) / len(frame)
    print(f"LZ4Engine({device.type}): ratio {ratio:.3f}, {info['block_count']} "
          f"block(s), {engine.stats.dispatches} dispatch(es), frame round-trip OK")

    # --- 1b. device-side emission: only final bytes cross to the host --------
    # device_emit=True (the default) emits the bytes on the device
    # (`emit_scatter`), so the host fetches one size and the block's bytes;
    # device_emit=False fetches the per-window match records and emits on
    # the host (the oracle path).  The frames are bit-identical either way.
    host_engine = LZ4Engine(device=device, device_emit=False)
    assert host_engine.compress(data) == frame
    print(f"device_emit: host transfer {engine.stats.host_bytes} B "
          f"vs {host_engine.stats.host_bytes} B for the records path "
          f"({host_engine.stats.host_bytes / engine.stats.host_bytes:.2f}x), "
          f"frames bit-identical")

    # --- 2. decompression: parallel decode + random access ------------------
    # The frame's block table doubles as a seek index: FrameReader.read_range
    # decodes ONLY the 64 KB blocks covering a byte range.  A host executor
    # (executor="thread" here) decodes blocks across host threads.
    big = b"the quick brown fox jumps over the lazy dog. " * 8000  # ~360 KB, 6 blocks
    big_frame = LZ4Engine(device=device).compress(big)
    reader = FrameReader(big_frame, engine=decoder)
    start, length = 200_000, 1_000
    assert reader.read_range(start, length) == big[start:start + length]
    lo, hi = reader.block_range(2)
    assert reader.read_block(2) == big[lo:hi]
    par = LZ4DecodeEngine(executor="thread", workers=2, device=device)
    assert par.decode(big_frame) == big
    par.close()
    blocks_touched = len(reader.blocks_for_range(start, length))
    print(f"random access: read_range({start}, {length}) decoded "
          f"{blocks_touched}/{reader.block_count} blocks; parallel decode OK")

    # The device executor plans and decodes on the device (`plan_speculative`,
    # `decode_wave`); decode_to_device returns the restored bytes as a uint8
    # tensor that never touched the host.
    dev = LZ4DecodeEngine(device=device, plan_on_device=True)
    assert dev.decode(big_frame) == big
    out = dev.decode_to_device(big_frame, verify=False)
    assert out.device.type == device.type
    assert bytes(out.cpu().numpy()) == big and dev.stats.host_bytes == 0
    print(f"device decode: {dev.stats.device_blocks} blocks in "
          f"{dev.stats.dispatches} dispatches; device-resident restore "
          f"fetched {dev.stats.host_bytes} plaintext bytes to host")

    # --- 3. scheme comparison (paper Tables I-III in miniature) --------------
    greedy = plan_size(compress_greedy(data, hash_bits=8))
    single = plan_size(compress_windowed(data, hash_bits=8, max_match=None).sequences)
    combined = plan_size(compress_windowed(data, hash_bits=8, max_match=36).sequences)
    print(f"software LZ4 (multi-match) : {len(data)/greedy:.3f}")
    print(f"single-match/window (S1)   : {len(data)/single:.3f}")
    print(f"combined (S1+S2, cap 36)   : {len(data)/combined:.3f}")

    # --- 4. why: deterministic hardware throughput (Table IV) ---------------
    t = ours_throughput(len(data))
    print(f"hardware model: {t.bytes_per_cycle:.3f} B/cycle -> "
          f"{list(t.gbps_at.values())[0]:.2f} Gb/s @ 251.57 MHz (paper: 16.10)")

    # --- 5. golden-model equivalence -----------------------------------------
    res = compress_windowed(data, hash_bits=8, max_match=36)
    blk = encode_block(data[:65536], res.sequences)
    assert decode_block(blk) == data[:65536]
    print("golden numpy model == exact LZ4 block format, decoder verified")


if __name__ == "__main__":
    main()
