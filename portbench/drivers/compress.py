"""Driver of the write path: `LZ4Engine.compress` of the run's object, one
call after another, and the comparison that judges the frames.

Each frame judged is held to the plain reference (`reference/lz4_paper.py`):
its header and every block-table entry (size, CRC-32, raw payloads); every
coded block, decoded by the reference's decoder and compared with its block
of the object; and a sample of blocks drawn from the seed (plus the first
and the last), whose raw flag and bytes must equal the reference
compressor's.  The last frame is decoded first; a judged frame equal byte
for byte to one already decoded takes its count.

The control puts the program in the place with the cap of scheme S2 broken:
``max_match`` past the configuration's (2 x max_match - 4, the next value of
the paper's sweep), which the sampled payloads must show.  ``plant_fault``
breaks the timed path underneath instead: one byte of one row of every
dispatch's payloads altered where the write kernels produce it.
"""
from __future__ import annotations

import contextlib

from portbench.objects import rng_of
from portbench.reference import lz4_paper as ref

LIMITS = {"table_errors": 0, "payload_errors": 0, "decode_errors": 0}
SAMPLE_BLOCKS = 24          # blocks per judged frame, besides the first and last
FAULT_ROW, FAULT_BYTE = 5, 10


@contextlib.contextmanager
def plant_fault():
    """While open, the program's payloads have byte FAULT_BYTE of row
    FAULT_ROW of each dispatch altered as they are produced."""
    from repro_torch.core import engine

    real = engine.compress_blocks_bytes

    def broken(blocks_u8, ns, **kw):
        out, size = real(blocks_u8, ns, **kw)
        if out.shape[0] > FAULT_ROW:
            out[FAULT_ROW, FAULT_BYTE] ^= 0x5A
        return out, size

    engine.compress_blocks_bytes = broken
    try:
        yield
    finally:
        engine.compress_blocks_bytes = real


class Driver:
    def __init__(self, config: dict, traffic: dict, obj: bytes, device,
                 telemetry: bool, control: bool = False, seed: int = 0):
        from repro_torch import LZ4Engine

        self.config = config
        self.obj = obj
        write = config["write"]
        self.max_match = config["max_match"]
        self.engine = LZ4Engine(
            hash_bits=config["hash_bits"], pws=config["pws"],
            max_match=2 * self.max_match - 4 if control else self.max_match,
            micro_batch=traffic["blocks_per_dispatch"],
            device_emit=write["device_emit"], drain=write["drain"],
            telemetry=telemetry, device=device)

    def call(self):
        """One call: (bytes in, bytes out, the frame)."""
        frame = self.engine.compress(self.obj)
        return len(self.obj), len(frame), frame

    def counters(self) -> dict:
        return self.engine.stats.as_dict()

    def free(self) -> None:
        self.engine = None

    def check(self, frames: list, seed: int) -> dict:
        c = self.config
        crcs = ref.block_crcs(self.obj)
        nblocks = len(crcs)
        rng = rng_of(seed, 2)
        total = dict.fromkeys(LIMITS, 0)
        decoded: list = []              # (frame, decode_errors)
        for frame in reversed(frames):
            pick = rng.choice(nblocks, min(SAMPLE_BLOCKS, nblocks), replace=False)
            sample = sorted(set(pick.tolist()) | {0, nblocks - 1})
            same = next((n for f, n in decoded if f == frame), None)
            got = ref.check_frame(frame, self.obj, crcs, sample, c["hash_bits"],
                                  c["pws"], self.max_match, decode=same is None)
            if same is None:
                decoded.append((frame, got["decode_errors"]))
            else:
                got["decode_errors"] = same
            for k in total:
                total[k] += got[k]
        return total
