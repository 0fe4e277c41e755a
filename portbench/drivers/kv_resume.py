"""Driver of KV-cache resume: `serving.restore_cache(blob, engine,
to_device=True)` of each of the traffic's parked sessions, one call (all of
them) after another, and the comparison that judges the restored trees.

Set-up draws the model's weights from the seed on the device
(`lm.init_params`), builds each session's cache with `lm.prefill` of a
prompt drawn from the seed (ids uniform over the vocabulary) into a static
cache of the configuration's ``cache_len`` positions, frees the weights,
and parks each session with `serving.offload_cache` through an `LZ4Engine`
under the configuration.  The parked blobs are the input; the caches stay
on the device to judge against.

Each judged output (one restored tree a session) is compared leaf by leaf
with the kept caches: ``bytes_wrong`` counts the bytes that differ (and
those missing or extra), ``leaves_wrong`` the leaves (or sessions) missing
or extra and those whose dtype, shape or device differs or that are not a
view of the decoded bytes.  ``host_bytes`` is the plaintext the decode
engine fetched to the host over the run.  Besides, the plain reference
(`reference/kv_resume.py`) resumes the parked blobs once, with its own
frame reader, decoder and zlib's CRC-32; its bytes that differ from the
kept caches count in ``bytes_wrong``, its leaves of another dtype or shape
in ``leaves_wrong``.

The control puts the program in the place with the guarantee of
``read.verify`` broken: one literal byte altered in one coded block in 16
of every frame (the caches' zero tails; `drivers/decode.py`'s `damage`),
and the CRCs left unchecked.  ``plant_fault`` breaks the raw-block path
underneath instead: the first byte of each raw block altered once it is on
the device, past its CRC-32 on the host.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from portbench.drivers.decode import damage
from portbench.objects import rng_of
from portbench.reference import kv_resume as ref
from portbench.reference import lz4_paper

LIMITS = {"bytes_wrong": 0, "leaves_wrong": 0, "host_bytes": 0}


@contextlib.contextmanager
def plant_fault():
    """While open, the first byte of every raw block that the decode engine
    puts on the device is altered after its CRC-32 was checked."""
    from repro_torch.core.decode_engine import LZ4DecodeEngine

    real = LZ4DecodeEngine._host_result

    def broken(self, data, to_device):
        out = real(self, data, to_device)
        if to_device and out.numel():
            out[0] ^= 0x5A
        return out

    LZ4DecodeEngine._host_result = broken
    try:
        yield
    finally:
        LZ4DecodeEngine._host_result = real


def model_config(model: dict):
    """The model as the configuration's ``model`` states it: the layer
    pattern of its ``arch`` at the file's depth, widths and compute dtype
    (config.json's key names)."""
    from repro_torch.configs import get_config

    cfg = get_config(model["arch"])
    (seg,) = cfg.segments
    layers = model["num_hidden_layers"]
    return dataclasses.replace(
        cfg, n_layers=layers, segments=(dataclasses.replace(seg, repeats=layers),),
        d_model=model["hidden_size"], d_ff=model["intermediate_size"],
        n_heads=model["num_attention_heads"], n_kv_heads=model["num_key_value_heads"],
        head_dim=model["head_dim"], vocab_size=model["vocab_size"],
        compute_dtype=model["torch_dtype"])


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    return t.detach().reshape(-1).view(torch.uint8)


def bytes_differ(got: torch.Tensor, want: torch.Tensor) -> int:
    """Bytes of ``got`` that differ from ``want``'s, plus any missing or
    extra, compared on ``want``'s device."""
    a, b = _as_bytes(got).to(want.device), _as_bytes(want)
    n = min(a.numel(), b.numel())
    return abs(a.numel() - b.numel()) + int(torch.count_nonzero(a[:n] != b[:n]))


class Driver:
    def __init__(self, config: dict, traffic: dict, obj: bytes, device,
                 telemetry: bool, control: bool = False, seed: int = 0):
        from repro_torch import LZ4DecodeEngine, LZ4Engine, obs
        from repro_torch._tree import flatten
        from repro_torch.models import lm
        from repro_torch.serving import engine as serving

        self.device = torch.device(device)
        model = config["model"]
        cfg = model_config(model)
        gen = torch.Generator(self.device).manual_seed(
            int(rng_of(seed, 10).integers(0, 2**62)))
        params = lm.init_params(cfg, gen, device=self.device)
        rng = rng_of(seed, 11)
        self.caches = []
        for n in traffic["sessions"]:
            ids = rng.integers(0, cfg.vocab_size, (model["batch"], n)).astype(np.int32)
            cache, _ = lm.prefill(params, {"tokens": torch.from_numpy(ids).to(self.device)},
                                  cfg, config["cache_len"])
            self.caches.append(cache)
        del params, cache
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        write, read = config["write"], config["read"]
        writer = LZ4Engine(hash_bits=config["hash_bits"], pws=config["pws"],
                           max_match=config["max_match"],
                           device_emit=write["device_emit"], drain=write["drain"],
                           device=device)
        self.blobs = [serving.offload_cache(c, engine=writer)[0] for c in self.caches]
        del writer
        self.timed = self.blobs
        if control:
            self.timed = [[treedef, [dict(b, frame=damage(b["frame"], seed)) for b in blobs]]
                          for treedef, blobs in self.blobs]
        self.verify = read["verify"] and not control
        self.engine = LZ4DecodeEngine(
            device=device, plan_on_device=read["plan_on_device"],
            micro_batch=traffic["blocks_per_dispatch"], telemetry=telemetry)
        self.bytes_in = sum(len(b["frame"]) for _, blobs in self.timed for b in blobs)
        self.bytes_out = sum(_as_bytes(x).numel()
                             for c in self.caches for x in flatten(c)[0])
        # `serving.restore`'s span and counters follow the global switch.
        self.obs_was = obs.is_enabled()
        if telemetry:
            obs.configure(enabled=True)
        self.host_bytes = 0

    def call(self):
        """One call: (bytes in, bytes out, the restored trees)."""
        from repro_torch.serving.engine import restore_cache

        out = [restore_cache(b, self.engine, to_device=True, verify=self.verify)
               for b in self.timed]
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self.bytes_in, self.bytes_out, out

    def counters(self) -> dict:
        from repro_torch import obs

        raw = np.concatenate([lz4_paper.read_frame(leaf["frame"])["raw"]
                              for _, blobs in self.timed for leaf in blobs])
        return dict(self.engine.totals.as_dict(), frame_blocks=int(raw.size),
                    frame_raw_blocks=int(raw.sum()),
                    tracer_dropped=obs.tracer().dropped)

    def free(self) -> None:
        from repro_torch import obs

        self.host_bytes = self.engine.totals.host_bytes
        self.engine = None
        obs.configure(enabled=self.obs_was)

    def check(self, outputs: list, seed: int) -> dict:
        from repro_torch._tree import flatten

        wants = [flatten(c)[0] for c in self.caches]
        wrong = leaves = 0
        for trees in outputs:
            leaves += abs(len(trees) - len(wants))
            for tree, want in zip(trees, wants):
                got = flatten(tree)[0]
                leaves += abs(len(got) - len(want))
                for g, w in zip(got, want):
                    leaves += int(g.dtype != w.dtype or g.shape != w.shape
                                  or g.device != w.device or not g._is_view())
                    wrong += bytes_differ(g, w)
        for blob, want in zip(self.blobs, wants):
            try:
                got = ref.flatten(ref.resume(blob))
            except ValueError:
                wrong += sum(_as_bytes(w).numel() for w in want)
                continue
            leaves += abs(len(got) - len(want))
            for g, w in zip(got, want):
                leaves += int(g.dtype != str(w.dtype).removeprefix("torch.")
                              or g.shape != tuple(w.shape))
                wrong += bytes_differ(torch.from_numpy(g.data), w)
        return {"bytes_wrong": wrong, "leaves_wrong": leaves,
                "host_bytes": self.host_bytes}
