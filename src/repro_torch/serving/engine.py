"""Batched serving engine: prefill + decode loop with a request scheduler,
and LZ4 KV-cache offload for paused sessions — the port of the JAX
package's `serving/engine.py`.

Static-batch design: requests are grouped into batches of at most
``max_batch``; prompts are right-aligned and padded to the batch max, and
decode proceeds greedily until ``max_new_tokens``.  The loop runs eagerly
on ``device`` (the card by default; no ``torch.compile``, no CUDA graph).

A paused session's cache (a tree of tensors) is serialized and compressed
leaf by leaf through an `LZ4Engine` (serialize -> compress -> host RAM or
disk) and restored bit-exactly — with ``to_device=True`` decoded on the card
into a uint8 tensor that each leaf is a view of, so no plaintext byte
crosses to the host.  Blobs are the reference's: one self-describing frame
per leaf with its shape and dtype name, byte-identical between packages.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch._tree import flatten, leaf_bytes, leaf_from_bytes, torch_dtype, unflatten
from repro_torch.configs.base import ModelConfig
from repro_torch.core.decode_engine import FrameReader, default_decode_engine
from repro_torch.core.engine import default_engine
from repro_torch.core.frame import block_crc, encode_frame
from repro_torch.models import lm
from repro_torch.resilience.errors import FrameError

__all__ = ["Request", "ServingEngine", "offload_cache", "restore_cache",
           "OffloadedCacheReader"]


@dataclasses.dataclass
class Request:
    uid: int
    prompt: list[int]
    max_new_tokens: int = 16
    output: list | None = None


class ServingEngine:
    """Greedy batched generation over ``params`` (on ``device``)."""

    def __init__(self, cfg: ModelConfig, params, max_batch: int = 4,
                 cache_len: int = 256, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        if params["embed"].device != self.device:
            raise ValueError(f"params are on {params['embed'].device}, the engine "
                             f"serves on {self.device}")
        self.cfg = cfg
        self.params = params
        self.max_batch = max_batch
        self.cache_len = cache_len
        self.queue: list[Request] = []

    def add_request(self, req: Request):
        self.queue.append(req)

    def _run_batch(self, reqs: list[Request]) -> None:
        cfg, dev = self.cfg, self.device
        cdt = getattr(torch, cfg.compute_dtype)
        B = len(reqs)
        max_p = max(len(r.prompt) for r in reqs)
        toks = np.zeros((B, max_p), np.int32)
        for i, r in enumerate(reqs):  # right-align so last token is real
            toks[i, max_p - len(r.prompt):] = r.prompt
        batch = {"tokens": torch.from_numpy(toks).to(dev)}
        if cfg.family == "encdec":
            batch["enc_embeds"] = torch.zeros((B, cfg.enc_seq, cfg.d_model), dtype=cdt,
                                              device=dev)
        if cfg.family == "vlm":
            batch["vision_embeds"] = torch.zeros((B, cfg.vision_tokens, cfg.d_model),
                                                 dtype=cdt, device=dev)
        with obs.span("serving.prefill", batch=B, max_prompt=max_p):
            cache, logits = lm.prefill(self.params, batch, cfg, self.cache_len)
        outs = [[] for _ in reqs]
        steps = max(r.max_new_tokens for r in reqs)
        tok = torch.argmax(logits, -1).to(torch.int32)
        with obs.span("serving.decode_loop", batch=B, steps=steps):
            for _ in range(steps):
                for o, t in zip(outs, tok.tolist()):
                    o.append(t)
                logits, cache = lm.decode_step(self.params, cache, tok, cache["pos"], cfg)
                tok = torch.argmax(logits, -1).to(torch.int32)
        for r, o in zip(reqs, outs):
            r.output = o[: r.max_new_tokens]

    def run(self) -> list[Request]:
        done = []
        while self.queue:
            batch = self.queue[: self.max_batch]
            self.queue = self.queue[self.max_batch:]
            self._run_batch(batch)
            done.extend(batch)
        return done


def offload_cache(cache, engine=None) -> tuple[list, dict]:
    """Serialize + LZ4-compress a cache tree. Returns (blob, stats).

    Each leaf becomes one self-describing frame: the engine (``engine``, or
    `default_engine()` on the card) batches all of the leaf's 64 KB blocks
    into micro-batched dispatches, and uncompressible blocks ride the
    frame's raw-passthrough flag.  ``blob`` is ``[treedef, blobs]``.
    """
    t0 = time.perf_counter()
    with obs.span("serving.offload"):
        leaves, treedef = flatten(cache)
        blobs = []
        raw_total = comp_total = 0
        for leaf in leaves:
            u8, dtype, shape = leaf_bytes(leaf)
            raw = u8.tobytes()
            if len(raw) >= 1024:
                frame = (engine or default_engine()).compress(raw)
            elif raw:
                # Tiny leaf: a raw single-block frame, no kernel dispatch.
                frame = encode_frame([raw], [len(raw)], [True], checksums=[block_crc(raw)])
            else:
                frame = encode_frame([], [], [], checksums=[])
            blobs.append({"shape": shape, "dtype": dtype, "frame": frame})
            raw_total += len(raw)
            comp_total += len(frame)
    stats = {"raw": raw_total, "compressed": comp_total,
             "ratio": raw_total / max(comp_total, 1)}
    if obs.is_enabled():
        obs.counter("serving.offloads", "cache offloads").inc()
        obs.counter("serving.offload_bytes_raw",
                    "serialized cache bytes in").inc(raw_total)
        obs.counter("serving.offload_bytes_compressed",
                    "frame bytes out").inc(comp_total)
        obs.histogram("serving.offload_seconds",
                      help="offload_cache latency").observe(
            time.perf_counter() - t0)
        obs.histogram("serving.offload_ratio", obs.DEFAULT_RATIO_BUCKETS,
                      "whole-cache compression ratio").observe(stats["ratio"])
    return [treedef, blobs], stats


def _device_view(u8: torch.Tensor, dtype: str, shape) -> torch.Tensor:
    """Reinterpret a uint8 tensor as ``dtype`` and reshape — a view of the
    same memory (no copy, no transfer; byte order is little-endian either
    way)."""
    return u8.view(torch_dtype(dtype)).reshape(tuple(shape))


def restore_cache(obj, decode_engine=None, to_device: bool = False,
                  verify: bool = True, on_error: str = "raise",
                  report: dict | None = None):
    """Full restore: every leaf frame through the decode engine
    (``decode_engine``, or `default_decode_engine()` on the card).  Leaves
    land on the engine's device.

    ``on_error="salvage"``: a leaf frame that fails strict decode falls
    back to the salvage pass (`repro_torch.resilience.salvage`) — every
    undamaged block is recovered, frame-v6 parity reconstructs what it
    can prove, and lost spans are zero-filled so the restored tree keeps
    its shapes.  Damage is recorded in ``report`` (leaf index ->
    `SalvageReport`) and the ``resilience.*`` obs counters — never
    silently.  The default ``"raise"`` keeps the strict contract.

    ``to_device=True`` routes each frame through `decode_to_device`: blocks
    are decoded on the device and each leaf is a view of the decoded uint8
    tensor.  With the default ``verify=True`` each block's CRC-32 runs on
    the device (the `crc32` kernel) and only the checksum is fetched, so no
    plaintext byte crosses to the host (`DecodeStats.host_bytes` 0);
    ``verify=False`` skips even that and defers integrity to the caller.
    An engine with ``plan_on_device=True`` keeps the token-stream planning
    on the device too.
    """
    if on_error not in ("raise", "salvage"):
        raise ValueError('on_error must be "raise" or "salvage"')
    t0 = time.perf_counter()
    treedef, blobs = obj
    eng = decode_engine or default_decode_engine()
    leaves = []
    with obs.span("serving.restore", leaves=len(blobs), to_device=to_device):
        for i, b in enumerate(blobs):
            if to_device:
                try:
                    raw = eng.decode_to_device(b["frame"], verify=verify)
                except FrameError:
                    if on_error != "salvage":
                        raise
                    # Host salvage, then upload: correctness first — the
                    # damaged-frame path is the rare one.
                    rep = eng.salvage(b["frame"])
                    if report is not None:
                        report[i] = rep
                    raw = eng._upload(np.frombuffer(rep.data, np.uint8).copy())
                leaves.append(_device_view(raw, b["dtype"], b["shape"]))
            else:
                try:
                    raw = eng.decode(b["frame"]) if on_error != "salvage" \
                        else eng._decode_strict(b["frame"])
                except FrameError:
                    if on_error != "salvage":
                        raise
                    rep = eng.salvage(b["frame"])
                    if report is not None:
                        report[i] = rep
                    raw = rep.data
                leaves.append(leaf_from_bytes(raw, b["dtype"], b["shape"],
                                              eng.device))
        tree = unflatten(treedef, leaves)
    if obs.is_enabled():
        obs.counter("serving.restores", "cache restores").inc()
        obs.counter("serving.restore_leaves", "cache leaves restored").inc(len(leaves))
        obs.counter("serving.restore_bytes", "cache bytes restored").inc(
            sum(x.numel() * x.element_size() for x in leaves))
        obs.histogram("serving.restore_seconds",
                      help="restore_cache latency").observe(
            time.perf_counter() - t0)
    return tree


class OffloadedCacheReader:
    """Random access into an offloaded cache without a full restore.

    Each leaf frame gets a lazy `FrameReader`, so a read decodes only the
    64 KB blocks covering the requested element range (the frame block
    table is the seek index) — single-block reads stay single-block.

    ``to_device=True`` makes every read return a tensor on the engine's
    device: the covering blocks are decoded there and sliced and viewed
    there, with no plaintext byte crossing to the host (with the default
    ``verify=True`` each block's CRC-32 runs on the device and only the
    checksum is fetched).  Otherwise reads return CPU tensors.

    >>> rdr = OffloadedCacheReader(blob)
    >>> rdr.read_leaf(3, start=128, count=64)   # 64 elements, ~1 block decoded
    """

    def __init__(self, obj, decode_engine=None, to_device: bool = False,
                 verify: bool = True, on_error: str = "raise"):
        if on_error not in ("raise", "salvage"):
            raise ValueError('on_error must be "raise" or "salvage"')
        self._treedef, self._blobs = obj
        self._engine = decode_engine or default_decode_engine()
        self._to_device = to_device
        self._verify = verify
        # on_error="salvage": leaf readers are built with the tolerant table
        # parse (damaged leaves still expose their readable blocks) and
        # `salvage_leaf` recovers a whole leaf with holes accounted for.
        self.on_error = on_error
        self._readers: list[FrameReader | None] = [None] * len(self._blobs)

    def __len__(self) -> int:
        return len(self._blobs)

    def leaf_meta(self, i: int) -> tuple[tuple, str]:
        """(shape, dtype name) of leaf i."""
        b = self._blobs[i]
        return tuple(b["shape"]), b["dtype"]

    def _reader(self, i: int) -> FrameReader:
        if self._readers[i] is None:
            self._readers[i] = FrameReader(self._blobs[i]["frame"],
                                           engine=self._engine,
                                           on_error=self.on_error)
        return self._readers[i]

    def salvage_leaf(self, i: int):
        """Salvage pass over leaf i's frame: decode every undamaged block,
        reconstruct from v6 parity where provable, zero-fill the rest.
        Returns the `SalvageReport` — its ``data`` is the leaf's full-length
        serialized buffer."""
        return self._engine.salvage(self._blobs[i]["frame"])

    def read_leaf_bytes(self, i: int, start: int = 0,
                        length: int | None = None) -> bytes:
        """Byte range of leaf i's serialized buffer (seek-indexed decode)."""
        reader = self._reader(i)
        if length is None:
            length = reader.usize - start
        return reader.read_range(start, length)

    def read_leaf(self, i: int, start: int = 0, count: int | None = None):
        """Flat element slice [start, start+count) of leaf i: a CPU tensor,
        or a tensor on the engine's device when the reader was built with
        ``to_device=True``."""
        shape, dtype = self.leaf_meta(i)
        itemsize = torch_dtype(dtype).itemsize
        total = int(np.prod(shape, dtype=np.int64)) if shape else 1
        if count is None:
            count = total - start
        if start < 0 or count < 0 or start + count > total:
            raise ValueError(f"slice [{start}, {start + count}) outside leaf of {total}")
        t0 = time.perf_counter()
        with obs.span("serving.read_leaf", leaf=i, count=count,
                      to_device=self._to_device):
            if self._to_device:
                raw = self._reader(i).read_range_device(
                    start * itemsize, count * itemsize, verify=self._verify)
                out = _device_view(raw, dtype, (count,))
            else:
                raw = self.read_leaf_bytes(i, start * itemsize, count * itemsize)
                out = leaf_from_bytes(raw, dtype, (count,), "cpu")
        if obs.is_enabled():
            obs.histogram("serving.read_leaf_seconds",
                          help="partial-restore (resume) read latency"
                          ).observe(time.perf_counter() - t0)
        return out

    def restore(self, report: dict | None = None):
        """Full tree restore (equivalent to `restore_cache`)."""
        return restore_cache([self._treedef, self._blobs], self._engine,
                             to_device=self._to_device, verify=self._verify,
                             on_error=self.on_error, report=report)
