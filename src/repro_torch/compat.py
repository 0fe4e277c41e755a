"""State carried between the JAX reference and this package, as numpy.

The system has no model parameters.  What crosses between the packages
(in the tests) is configuration and intermediate state: per-window match
records, the emit layout, and the keywords of both engines
(`engine_config`, `decode_engine_config`).  With these helpers a test
can feed the reference's output of one stage into this package's next stage
and localize a mismatch.  Nothing here imports the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.compressor import BlockRecords

# Reference-engine keywords with no meaning here (dropped) and keywords that
# select machinery this package does not have yet (refused).
_DROPPED = ("use_pallas", "donate")
_REFUSED = ("mesh", "shard_axes", "shards")


def _t(a, dtype, device) -> torch.Tensor:
    # A copy: the source may be a read-only view of another framework's buffer.
    return torch.as_tensor(np.array(a, copy=True), dtype=dtype, device=device)


def _batched(a, ndim: int):
    a = np.asarray(a)
    return a[None] if a.ndim == ndim - 1 else a


def records_from_numpy(emit, pos, length, offset, size, device="cpu") -> BlockRecords:
    """numpy match records -> BlockRecords; a single block (W,) gains M=1."""
    return BlockRecords(
        emit=_t(_batched(emit, 2), torch.bool, device),
        pos=_t(_batched(pos, 2), torch.int32, device),
        length=_t(_batched(length, 2), torch.int32, device),
        offset=_t(_batched(offset, 2), torch.int32, device),
        size=_t(_batched(size, 1), torch.int32, device),
    )


def records_to_numpy(rec: BlockRecords) -> dict[str, np.ndarray]:
    """BlockRecords -> dict of numpy arrays (keys: the field names)."""
    return {k: getattr(rec, k).cpu().numpy()
            for k in ("emit", "pos", "length", "offset", "size")}


def layout_from_numpy(seg, fields, total, device="cpu"):
    """numpy emit layout -> ``(seg (M, K), fields (M, 8, S), total (M,))``
    int32 tensors; a single block's layout gains M=1."""
    return (_t(_batched(seg, 2), torch.int32, device),
            _t(_batched(fields, 3), torch.int32, device),
            _t(_batched(total, 1), torch.int32, device))


def engine_config(**kw) -> dict:
    """Map the reference `LZ4Engine` keywords onto this package's.

    ``use_pallas`` / ``donate`` are dropped (there is one kernel route and
    no buffer donation); ``mesh`` / ``shard_axes`` / ``shards`` are refused
    unless None (the sharded fabric is not ported).  Everything else passes
    through; the caller adds ``device=``.
    """
    out = {}
    for k, v in kw.items():
        if k in _DROPPED:
            continue
        if k in _REFUSED:
            if v is not None:
                raise NotImplementedError(
                    f"{k}= selects the sharded fabric, which repro_torch "
                    "does not have yet")
            continue
        out[k] = v
    return out


def decode_engine_config(**kw) -> dict:
    """Map the reference `LZ4DecodeEngine` keywords onto this package's.

    ``use_pallas`` is dropped (there is one kernel route); ``mesh`` /
    ``shard_axes`` are refused unless None (the sharded fabric, ROADMAP A8)
    and ``on_error="salvage"`` is refused (the salvage pass, ROADMAP A6).
    Everything else passes through; the caller adds ``device=``.
    """
    out = {}
    for k, v in kw.items():
        if k == "use_pallas":
            continue
        if k in ("mesh", "shard_axes"):
            if v is not None:
                raise NotImplementedError(
                    f"{k}= selects the sharded fabric, which repro_torch "
                    "does not have yet (ROADMAP queue A, item A8)")
            continue
        if k == "on_error" and v == "salvage":
            raise NotImplementedError(
                'on_error="salvage" needs the salvage pass, which '
                "repro_torch does not have yet (ROADMAP queue A, item A6)")
        out[k] = v
    return out
