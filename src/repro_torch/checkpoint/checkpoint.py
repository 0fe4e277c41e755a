"""Fault-tolerant checkpointing with LZ4 block compression, on the card.

The port of the JAX package's `checkpoint/checkpoint.py`: the same layout,
manifest, digests, crash seams and retries, so a checkpoint either package
writes restores in the other (data.bin and manifest.json are byte-identical
for the same tree).

Layout (atomic: written to <dir>.tmp then os.rename'd):
    ckpt_<step>/
      manifest.json   # tree structure, shapes, dtypes, per-leaf block index,
                      # crc32 checksums, compressed sizes
      data.bin        # concatenated (possibly LZ4-compressed) 64 KB blocks

Properties:
  * leaves are torch tensors (any device; ``bfloat16`` is written under the
    name ``"bfloat16"``, as the JAX package does), numpy arrays or Python
    scalars; trees are nested dict/list/tuple, dict keys in sorted order;
  * every leaf is chunked into 64 KB blocks and compressed by an
    `LZ4Engine` (the card's by default: the write kernels); incompressible
    blocks are stored raw (per-block flag) so worst-case overhead is ~0;
  * restore decodes each leaf's blocks through an `LZ4DecodeEngine` (the
    card's by default: the read kernels) and puts each leaf on the device of
    the matching leaf of ``like`` — the card for a ``device="meta"``
    placeholder;
  * async saves: the snapshot is a copy taken before `save` returns (CUDA
    tensors copied to the host, CPU tensors cloned), then written on a
    background thread, so an in-place optimizer step cannot tear it;
  * corrupt checkpoints (bad checksum / truncation) raise CheckpointError;
    `restore_with_fallback` steps back to the newest step that verifies, and
    ``restore(..., on_error="salvage")`` recovers every undamaged block of
    a corrupt checkpoint (zero-filling the rest, with a full accounting);
  * saves are CRASH-CONSISTENT: data and manifest are written into
    ``ckpt_<step>.tmp``, fsync'd (files, then the tmp dir, then the parent
    after the rename), and atomically renamed into place — a writer killed
    at ANY point leaves either the previous complete checkpoint set or the
    new complete checkpoint (the named `crash_point` seams below);
  * the manifest carries content digests of the written artifact itself
    (``data_size`` / ``data_crc32`` over data.bin, per-leaf ``comp_crc32``
    over the stored block bytes), so restore detects torn or stale data
    BEFORE attempting any decode;
  * transient I/O failures (injected via `repro_torch.resilience.inject`)
    are retried with decorrelated-jitter backoff
    (`repro_torch.resilience.retry`) around file opens and block reads.

``restore(shardings=...)`` places each leaf by a
`repro_torch.distributed.sharding.NamedSharding` through `device_put`: on
the one device its mesh holds, or as a `ShardedTensor` split or replicated
over a mesh of distinct devices (the reference's one global array).
"""
from __future__ import annotations

import binascii
import json
import os
import shutil
import threading
import time

from repro_torch import obs
from repro_torch._tree import flatten_with_paths as _flatten
from repro_torch._tree import leaf_bytes, leaf_from_bytes, target_device
from repro_torch.core.decode_engine import default_decode_engine
from repro_torch.core.decoder import LZ4FormatError
from repro_torch.core.engine import default_engine
from repro_torch.core.lz4_types import MAX_BLOCK
from repro_torch.distributed.sharding import check_sharding, device_put
from repro_torch.kernels._build import KernelRefusal
from repro_torch.resilience import retry as _retry
from repro_torch.resilience.errors import FrameError
from repro_torch.resilience.inject import crash_point, io_point

__all__ = ["CheckpointError", "save", "restore", "restore_with_fallback",
           "latest_step"]


class CheckpointError(FrameError, RuntimeError):
    """Corrupt, torn, or unrestorable checkpoint.

    RuntimeError for backwards compatibility; `FrameError` joins it to the
    unified corruption hierarchy (structured ``cause`` attribute) so one
    handler covers frame and checkpoint damage."""


# Transient-I/O retry schedule for checkpoint file opens and block reads
# (seeded: the chaos tests pin its behaviour; cap small — this guards
# against flaky mounts, not outages).
_IO_RETRY = _retry.RetryPolicy(max_attempts=4, base_s=0.01, cap_s=0.2, seed=0)


def _open_retrying(path: str, mode: str):
    """`open` with transient-failure retries (io_point: checkpoint.open)."""
    def attempt():
        io_point("checkpoint.open")
        return open(path, mode)
    return _retry.call(attempt, policy=_IO_RETRY)


def _fsync_dir(path: str) -> None:
    """fsync a DIRECTORY so its entry mutations (create/rename) are durable
    — rename atomicity alone does not survive power loss without this."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _compress_leaf(raw: bytes, use_engine: bool,
                   engine=None) -> list[tuple[bool, bytes]]:
    """(is_lz4, stored bytes) per 64 KB chunk of ``raw``: the engine's block
    where it is smaller than the chunk, else the chunk itself."""
    chunks = [raw[i: i + MAX_BLOCK] for i in range(0, max(len(raw), 1), MAX_BLOCK)]
    # One engine call per leaf: all of the leaf's blocks go through
    # micro-batched dispatches instead of one call per 64 KB chunk.
    lz_blocks = (
        (engine or default_engine()).compress_to_blocks(raw)
        if use_engine and len(raw) >= 1024 else None
    )
    blocks = []
    for i, chunk in enumerate(chunks):
        lz = lz_blocks[i] if lz_blocks is not None else None
        if lz is not None and len(lz) < len(chunk):
            blocks.append((True, lz))
        else:
            blocks.append((False, chunk))
    return blocks


def save(ckpt_dir: str, step: int, tree, *, compress: bool = True,
         async_write: bool = False, keep_last: int = 3, engine=None):
    """Write a checkpoint. Returns the final path (or a Thread if async).

    `engine`: optional `LZ4Engine` override (default: `default_engine()`,
    on the card; ``LZ4Engine(device="cpu")`` runs the kernels' plain
    versions).  Block bytes are identical either way, so checkpoints stay
    interchangeable.
    """
    # Snapshot synchronously (a copy of every leaf), write possibly in
    # background.
    with obs.span("checkpoint.snapshot", step=step):
        leaves = [(p, *leaf_bytes(x)) for p, x in _flatten(tree)]

    def _write():
        t0 = time.perf_counter()
        raw_total = 0
        final = os.path.join(ckpt_dir, f"ckpt_{step}")
        tmp = final + ".tmp"
        with obs.span("checkpoint.save", step=step, leaves=len(leaves)):
            # A stale .tmp is debris from a previous writer killed mid-save
            # (the kill-in-the-middle tests produce exactly this); it is
            # never restorable state, so replace it wholesale.
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            manifest = {"step": step, "leaves": []}
            data_crc = 0
            with _open_retrying(os.path.join(tmp, "data.bin"), "wb") as f:
                for path, u8, dtype, shape in leaves:
                    raw = u8.tobytes()
                    raw_total += len(raw)
                    blocks = _compress_leaf(raw, compress, engine)
                    entry = {
                        "path": path,
                        "shape": list(shape),
                        "dtype": dtype,
                        "raw_size": len(raw),
                        "crc32": binascii.crc32(raw) & 0xFFFFFFFF,
                        "comp_crc32": 0,
                        "blocks": [],
                    }
                    comp_crc = 0
                    for is_comp, data in blocks:
                        entry["blocks"].append(
                            {"offset": f.tell(), "size": len(data), "lz4": bool(is_comp)}
                        )
                        f.write(data)
                        comp_crc = binascii.crc32(data, comp_crc)
                        data_crc = binascii.crc32(data, data_crc)
                    entry["comp_crc32"] = comp_crc & 0xFFFFFFFF
                    manifest["leaves"].append(entry)
                    # Crash seam: data.bin torn mid-leaf, no manifest yet.
                    crash_point("checkpoint.data")
                data_bytes = f.tell()
                f.flush()
                os.fsync(f.fileno())
            # Digests of the artifact itself: restore verifies the bytes it
            # reads ARE the bytes this writer wrote, before any decode.
            manifest["data_size"] = data_bytes
            manifest["data_crc32"] = data_crc & 0xFFFFFFFF
            # Crash seam: complete data.bin, manifest never written.
            crash_point("checkpoint.manifest")
            with _open_retrying(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            _fsync_dir(tmp)
            # Crash seam: complete .tmp, never renamed into place.
            crash_point("checkpoint.rename")
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            _fsync_dir(ckpt_dir)
            # Crash seam: renamed, old checkpoints not yet pruned.
            crash_point("checkpoint.cleanup")
            _cleanup(ckpt_dir, keep_last)
        if obs.is_enabled():
            obs.counter("checkpoint.saves", "checkpoints written").inc()
            obs.counter("checkpoint.save_bytes_raw",
                        "leaf bytes snapshotted").inc(raw_total)
            obs.counter("checkpoint.save_bytes_written",
                        "data.bin bytes written").inc(data_bytes)
            obs.histogram("checkpoint.save_seconds",
                          help="checkpoint write latency").observe(
                time.perf_counter() - t0)
        return final

    if async_write:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    return _write()


def _steps(ckpt_dir: str) -> list[int]:
    return [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
            if d.startswith("ckpt_") and not d.endswith(".tmp")]


def _cleanup(ckpt_dir: str, keep_last: int):
    for s in sorted(_steps(ckpt_dir))[:-keep_last]:
        shutil.rmtree(os.path.join(ckpt_dir, f"ckpt_{s}"), ignore_errors=True)


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _steps(ckpt_dir)
    return max(steps) if steps else None


def _read_block(f, offset: int, size: int, path: str) -> bytes:
    """One positioned block read with transient-failure retries
    (io_point: checkpoint.read)."""
    def attempt():
        io_point("checkpoint.read")
        f.seek(offset)
        return f.read(size)
    data = _retry.call(attempt, policy=_IO_RETRY)
    if len(data) != size:
        raise CheckpointError(f"truncated block in {path}", cause="truncated")
    return data


def _salvage_leaf(eng, e: dict, payloads, raws) -> tuple[bytes, list[int]]:
    """Per-block decode of one leaf, zero-filling failures.

    Chunk i of a leaf covers raw bytes [i*MAX_BLOCK, min((i+1)*MAX_BLOCK,
    raw_size)) — the save-side `_compress_leaf` split — so a failed block
    zero-fills exactly its span.  Only corruption (`LZ4FormatError`) counts
    as a failed block: a kernel's refusal or a launch failure propagates.
    Returns (raw bytes, failed block indices).
    """
    raw_size = e["raw_size"]
    parts, failed = [], []
    for i, (p, r) in enumerate(zip(payloads, raws)):
        span = min(MAX_BLOCK, raw_size - i * MAX_BLOCK) if raw_size else 0
        try:
            parts.append(eng.decode_blocks([p], [r], usizes=[span])[0])
        except LZ4FormatError:
            parts.append(b"\x00" * span)
            failed.append(i)
    return b"".join(parts)[:raw_size], failed


def _shardings_by_path(like, shardings) -> dict:
    """Leaf path -> `NamedSharding`, for every leaf of ``like`` that
    ``shardings`` (a tree of ``like``'s structure holding NamedSharding or
    None) places; checked before any block is read."""
    out = {}

    def walk(tree, sh, path):
        if isinstance(tree, dict):
            if not isinstance(sh, dict) or set(sh) != set(tree):
                raise ValueError(f"shardings do not match the tree at {path or '/'}")
            for k in tree:
                walk(tree[k], sh[k], f"{path}/{k}")
        elif isinstance(tree, (list, tuple)):
            if not isinstance(sh, (list, tuple)) or len(sh) != len(tree):
                raise ValueError(f"shardings do not match the tree at {path or '/'}")
            for i, (t, s) in enumerate(zip(tree, sh)):
                walk(t, s, f"{path}/{i}")
        elif tree is not None and sh is not None:
            out[path] = check_sharding(sh, f"sharding of {path}")

    if shardings is not None:
        walk(like, shardings, "")
    return out


def restore(ckpt_dir: str, step: int, like, shardings=None,
            decode_engine=None, on_error: str = "raise",
            report: dict | None = None):
    """Rebuild the tree of `like` (a tree of tensors; ``device="meta"``
    tensors stand for shape-and-dtype placeholders).

    Each restored leaf has the manifest's dtype and shape and lives on the
    device of its ``like`` leaf — on the card when that is ``meta``.
    `shardings`: None, or a tree of ``like``'s structure holding
    `NamedSharding` or None (the ``like`` placement).  A leaf under a
    `NamedSharding` is placed by `distributed.sharding.device_put`, as the
    reference's `jax.device_put`: a plain tensor on the one device its mesh
    holds (e.g. any spec on a `single_device_mesh`), or a `ShardedTensor`
    over a mesh of distinct devices, split or replicated as the spec says;
    a dimension that does not divide over its axes raises ValueError.
    `decode_engine`: optional `LZ4DecodeEngine` override (default:
    `default_decode_engine()`, the device executor on the card).
    `on_error`: ``"raise"`` (default) fails the whole restore on the first
    corrupt block — the strict contract.  ``"salvage"`` decodes every
    undamaged block, ZERO-FILLS the spans of blocks that fail (so the
    restored tree keeps its shapes), and records the damage in `report`
    (``report["zero_filled"]``: leaf path -> failed block indices;
    ``report["crc_mismatch"]``: leaf paths whose whole-leaf checksum did
    not verify) plus the ``resilience.*`` obs counters — never silently.
    A structurally unreadable checkpoint (missing manifest, torn data.bin)
    still raises; `restore_with_fallback` handles stepping back.
    """
    if on_error not in ("raise", "salvage"):
        raise ValueError('on_error must be "raise" or "salvage"')
    placed = _shardings_by_path(like, shardings)
    t0 = time.perf_counter()
    eng = decode_engine or default_decode_engine()
    final = os.path.join(ckpt_dir, f"ckpt_{step}")
    man_path = os.path.join(final, "manifest.json")
    if not os.path.exists(man_path):
        raise CheckpointError(f"missing manifest: {man_path}",
                              cause="structure")
    with _open_retrying(man_path, "r") as f:
        manifest = json.load(f)
    by_path = {e["path"]: e for e in manifest["leaves"]}
    data_path = os.path.join(final, "data.bin")
    # Artifact digests: a torn or stale data.bin is rejected before any
    # block is decoded.
    if "data_size" in manifest:
        actual = os.path.getsize(data_path)
        if actual != manifest["data_size"]:
            raise CheckpointError(
                f"data.bin is {actual} bytes, manifest says "
                f"{manifest['data_size']}", cause="truncated")
    if report is not None:
        report.setdefault("zero_filled", {})
        report.setdefault("crc_mismatch", [])
    out_leaves = {}
    raw_total = 0
    with obs.span("checkpoint.restore", step=step), \
            _open_retrying(data_path, "rb") as f:
        for path, spec in _flatten(like):
            if path not in by_path:
                raise CheckpointError(f"leaf {path} not in checkpoint",
                                      cause="structure")
            e = by_path[path]
            payloads, raws = [], []
            for b in e["blocks"]:
                payloads.append(_read_block(f, b["offset"], b["size"], path))
                raws.append(not b["lz4"])
            # Stored-bytes digest: distinguishes media damage (the bytes on
            # disk changed) from a writer bug, before any decode runs.
            if e.get("comp_crc32") is not None and on_error == "raise":
                comp = 0
                for p in payloads:
                    comp = binascii.crc32(p, comp)
                if comp & 0xFFFFFFFF != e["comp_crc32"]:
                    raise CheckpointError(
                        f"stored bytes of {path} failed their digest",
                        cause="crc")
            # A leaf's blocks are independent: the decode engine runs them
            # in micro-batched dispatches (device executor) or across its
            # worker pool instead of a loop.
            failed: list[int] = []
            if on_error == "salvage":
                raw, failed = _salvage_leaf(eng, e, payloads, raws)
                if failed and report is not None:
                    report["zero_filled"][path] = failed
            else:
                try:
                    raw = b"".join(eng.decode_blocks(payloads, raws))
                except LZ4FormatError as err:
                    raise CheckpointError(f"corrupt block in {path}: {err}") from err
            with obs.span("decode.verify", leaf=path):
                if binascii.crc32(raw) & 0xFFFFFFFF != e["crc32"]:
                    if on_error == "raise":
                        raise CheckpointError(f"checksum mismatch for {path}",
                                              cause="crc")
                    if report is not None:
                        report["crc_mismatch"].append(path)
            if failed and obs.is_enabled():
                obs.counter("resilience.lost_blocks",
                            "blocks salvage could not recover").inc(len(failed))
            raw_total += len(raw)
            if path in placed:
                out_leaves[path] = device_put(
                    leaf_from_bytes(raw, e["dtype"], e["shape"], "cpu"), placed[path])
            else:
                out_leaves[path] = leaf_from_bytes(raw, e["dtype"], e["shape"],
                                                   target_device(spec))
    if obs.is_enabled():
        obs.counter("checkpoint.restores", "checkpoints restored").inc()
        obs.counter("checkpoint.restore_bytes_raw",
                    "leaf bytes restored").inc(raw_total)
        obs.histogram("checkpoint.restore_seconds",
                      help="checkpoint restore latency").observe(
            time.perf_counter() - t0)

    def rebuild(tree, path=""):
        if isinstance(tree, dict):
            return {k: rebuild(tree[k], f"{path}/{k}") for k in tree}
        if isinstance(tree, (list, tuple)):
            return type(tree)(rebuild(v, f"{path}/{i}") for i, v in enumerate(tree))
        if tree is None:
            return None
        return out_leaves[path]

    return rebuild(like), manifest["step"]


def restore_with_fallback(ckpt_dir: str, like, shardings=None,
                          decode_engine=None, max_steps_back: int | None = None):
    """Restore the NEWEST valid checkpoint, stepping back past corrupt ones.

    Walks the directory's steps newest-first, strict-restoring each until
    one verifies end to end.  Corrupt or torn steps are skipped (and
    counted: ``checkpoint.fallback_steps``), never deleted — they stay on
    disk for post-mortem salvage.  ``max_steps_back`` bounds the walk
    (None: try every step present).  Raises `CheckpointError` when no step
    restores.  Returns ``(tree, step)`` like `restore`.

    A kernel wrapper's refusal (`KernelRefusal`, a ValueError) is not damage
    and reaches the caller: stepping back past it would hide the device.
    """
    if not os.path.isdir(ckpt_dir):
        raise CheckpointError(f"no checkpoint directory: {ckpt_dir}",
                              cause="structure")
    steps = sorted(_steps(ckpt_dir), reverse=True)
    if max_steps_back is not None:
        steps = steps[: max_steps_back + 1]
    if not steps:
        raise CheckpointError(f"no checkpoints in {ckpt_dir}",
                              cause="structure")
    errors: list[str] = []
    for n, step in enumerate(steps):
        try:
            tree, got = restore(ckpt_dir, step, like, shardings=shardings,
                                decode_engine=decode_engine)
        except KernelRefusal:
            raise
        except (CheckpointError, OSError, ValueError, KeyError) as e:
            errors.append(f"step {step}: {e}")
            if obs.is_enabled():
                obs.counter("checkpoint.fallback_steps",
                            "corrupt checkpoint steps skipped by "
                            "restore_with_fallback").inc()
            continue
        if n and obs.is_enabled():
            obs.counter("checkpoint.fallback_restores",
                        "restores that landed on an older step").inc()
        return tree, got
    raise CheckpointError(
        "no valid checkpoint found; tried "
        + "; ".join(errors), cause="structure")
