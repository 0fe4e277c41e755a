"""Driver of the read path: `LZ4DecodeEngine.decode_to_device` of the frame of
the run's object, one call after another, and the comparison that judges
the decoded bytes.

Set-up makes the frame once, from the object, with `LZ4Engine` under the
cell's configuration: it is an input.  Each judged output, a uint8 tensor
on the card, is compared byte for byte with the object the benchmark made.

The control puts the program in the place with the guarantee of
``read.verify`` broken: one literal byte altered in one coded block in 16
(drawn from the seed), and the CRCs left unchecked, so the altered bytes
come back unnoticed unless the comparison catches them.
"""
from __future__ import annotations

import torch

from portbench.objects import rng_of
from portbench.reference import lz4_paper as ref

LIMITS = {"bytes_wrong": 0}
DAMAGE_EVERY = 16


def damage(frame: bytes, seed: int) -> bytes:
    """``frame`` with one literal byte altered in one coded block in
    DAMAGE_EVERY; the table, CRCs included, is left as it was."""
    info = ref.read_frame(frame)
    out = bytearray(frame)
    coded = [i for i in range(info["count"]) if not info["raw"][i]]
    rng = rng_of(seed, 3)
    for i in rng.permutation(coded)[: max(1, len(coded) // DAMAGE_EVERY)]:
        at = int(info["offsets"][i])
        payload = frame[at: at + int(info["csize"][i])]
        lit_at = next(a for a, n, _, _ in ref.parse_block(payload) if n)
        out[at + lit_at] ^= 0x5A
    return bytes(out)


class Driver:
    def __init__(self, config: dict, traffic: dict, obj: bytes, device,
                 telemetry: bool, control: bool = False, seed: int = 0):
        from repro_torch import LZ4DecodeEngine, LZ4Engine

        write, read = config["write"], config["read"]
        writer = LZ4Engine(hash_bits=config["hash_bits"], pws=config["pws"],
                           max_match=config["max_match"],
                           device_emit=write["device_emit"],
                           drain=write["drain"], device=device)
        self.frame = writer.compress(obj)
        self.frame_stats = writer.stats.as_dict()
        del writer
        self.obj = obj
        self.device = torch.device(device)
        self.verify = read["verify"] and not control
        if control:
            self.frame = damage(self.frame, seed)
        self.engine = LZ4DecodeEngine(
            device=device, plan_on_device=read["plan_on_device"],
            micro_batch=traffic["blocks_per_dispatch"], telemetry=telemetry)

    def call(self):
        """One call: (bytes in, bytes out, the decoded tensor)."""
        out = self.engine.decode_to_device(self.frame, verify=self.verify)
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
        return len(self.frame), int(out.numel()), out

    def counters(self) -> dict:
        return dict(self.engine.stats.as_dict(),
                    frame_raw_blocks=self.frame_stats["raw_blocks"])

    def free(self) -> None:
        self.engine = None

    def check(self, outputs: list, seed: int) -> dict:
        want = torch.frombuffer(bytearray(self.obj), dtype=torch.uint8)
        want = want.to(self.device)
        wrong = 0
        for out in outputs:
            n = min(out.numel(), want.numel())
            wrong += abs(out.numel() - want.numel())
            wrong += int(torch.count_nonzero(out[:n] != want[:n]))
        return {"bytes_wrong": wrong}
