"""Salvage decode: recover every undamaged block of a corrupted frame.

The port of the JAX package's `resilience/salvage.py`: the same layers, the
same report, the same span and counter names.  On the device executor each
block is its own dispatch (M = 1), so one poisoned payload fails only
itself; only corruption (`FrameError` / `LZ4FormatError`) is captured as a
damaged block — a kernel's refusal or a launch failure propagates.

The strict decode paths are all-or-nothing — one flipped bit fails the
whole frame, by design ("corruption is never silent").  Salvage is the
recovery half of that contract: when a frame IS damaged, decode everything
the damage did not touch, reconstruct what the frame-v6 parity section can
prove correct, and return an exact accounting of what was lost:

    report = salvage_frame(frame)            # or FrameReader(f).salvage()
    report.data          # full-length content, lost blocks zero-filled
    report.ok            # block indices that decoded clean
    report.reconstructed # blocks rebuilt byte-identically from XOR parity
    report.lost          # blocks neither decode nor parity could save
    report.holes         # merged [start, end) decompressed ranges lost
    report.errors        # block index -> what was wrong with it

Three layers of recovery, in order:

  1. Tolerant structure parse (`frame.scan_frame`): keep every readable
     table entry even when the strict parse rejects the frame.
  2. Per-block decode + verify on the engine's configured executor —
     serial/thread/process blocks go through ONE error-capturing `_map`
     fan-out (the pool stays busy; a bad block fails only itself); the
     device executor decodes per block so one poisoned payload cannot
     sink a stacked micro-batch.
  3. Frame-v6 parity reconstruction (`frame.xor_bytes`): any SINGLE failed
     block per parity group is rebuilt from the group's parity payload +
     surviving stored payloads, then RE-VALIDATED through the normal
     decode + `check_block` path — a reconstruction that cannot be proven
     byte-identical is counted lost, never returned.

Nothing in the report is guessed: ``data`` holes are zero-filled and
listed in ``holes``; `content_crc_ok` is only True when the whole object
re-verified against the v5/v6 trailer.  Counted through `repro_torch.obs`
when telemetry is on: ``resilience.salvaged_blocks`` /
``reconstructed_blocks`` / ``lost_blocks``.
"""
from __future__ import annotations

import dataclasses

from repro_torch import obs

from .errors import FrameError

__all__ = ["SalvageReport", "salvage_frame"]


def _salvage_block_task(args):
    """Decode + verify one block, CAPTURING failure instead of raising
    (module-level so it pickles for the process pool).  Returns
    ``(data | None, err_message | None, cause | None)``."""
    from repro_torch.core.decode_engine import _decode_one
    from repro_torch.core.decoder import LZ4FormatError
    from repro_torch.core.frame import check_block

    payload, usize, crc, index, raw, two_phase, ob = args
    try:
        data = payload if raw else _decode_one(payload, usize, two_phase, ob)
        check_block(index, usize, crc, data)
        return data, None, None
    except LZ4FormatError as e:          # includes FrameFormatError
        return None, str(e), getattr(e, "cause", None) or "parse"


@dataclasses.dataclass
class SalvageReport:
    """What a salvage pass recovered — and exactly what it could not.

    ``data`` is always ``content_size`` bytes long when the header said so
    (lost regions zero-filled); ``holes`` are the merged decompressed
    [start, end) ranges those zeros cover, so a caller can overlay
    recovered bytes onto a previous good copy.  ``errors`` maps each
    damaged block to the error that condemned it (reconstructed blocks
    keep their original error, annotated); ``notes`` carries structural
    anomalies from the tolerant parse.  ``content_crc_ok`` is True only
    when the FULL object re-verified against the frame trailer — None
    when there is no trailer or the object has holes.
    """

    data: bytes
    block_count: int
    ok: list[int]
    reconstructed: list[int]
    lost: list[int]
    holes: list[tuple[int, int]]
    errors: dict[int, str]
    notes: list[str]
    content_crc_ok: bool | None

    @property
    def complete(self) -> bool:
        """True when every block was recovered (decoded or reconstructed)."""
        return not self.lost and len(self.ok) + len(self.reconstructed) \
            == self.block_count


def _decode_blocks_capturing(engine, frame, blocks, ok_idx, st):
    """Per-block decode of ``ok_idx`` on the engine's executor, capturing
    failures.  Returns ``{index: data}`` and ``{index: (msg, cause)}``."""
    got: dict[int, bytes] = {}
    bad: dict[int, tuple[str, str]] = {}
    if engine.executor == "device":
        # Per-block dispatches: one poisoned payload must only fail itself,
        # and the device path raises out of a whole stacked micro-batch.
        for i in ok_idx:
            b = blocks[i]
            try:
                got[i] = engine._decode_entries_device(
                    frame, [(i, b)], to_device=False, verify=True, st=st)[0]
            except FrameError as e:
                bad[i] = (str(e), getattr(e, "cause", None) or "parse")
        return got, bad
    ob = engine._obs_on()
    args = []
    for i in ok_idx:
        b = blocks[i]
        payload = frame[b["offset"]: b["offset"] + b["csize"]]
        args.append((payload, b["usize"], b["crc"], i, b["raw"],
                     engine.two_phase, ob))
    for i, (data, msg, cause) in zip(
            ok_idx, engine._map(_salvage_block_task, args, st)):
        if data is not None:
            got[i] = data
        else:
            bad[i] = (msg, cause)
    return got, bad


def _reconstruct_from_parity(frame, info, failed, engine):
    """Rebuild single-failure parity groups.  Returns ``{index: data}``
    (verified decoded content) and ``{index: note}`` for groups parity
    could not save."""
    from repro_torch.core.decode_engine import _decode_one
    from repro_torch.core.decoder import LZ4FormatError
    from repro_torch.core.frame import block_crc, check_block, xor_bytes

    pg, parity = info["parity_group"], info["parity"]
    blocks = info["blocks"]
    rebuilt: dict[int, bytes] = {}
    why_not: dict[int, str] = {}
    if not pg or not parity:
        return rebuilt, why_not
    for i in sorted(failed):
        g = i // pg
        if g >= len(parity):
            why_not[i] = "parity group missing"
            continue
        group = range(g * pg, min((g + 1) * pg, len(blocks)))
        others = [j for j in group if j != i and j in failed]
        if others:
            why_not[i] = (f"parity group {g} has {1 + len(others)} damaged "
                          "blocks (XOR parity reconstructs one)")
            continue
        p = parity[g]
        if not p.get("ok", True):
            why_not[i] = f"parity group {g} unreadable"
            continue
        ppayload = frame[p["offset"]: p["offset"] + p["plen"]]
        if block_crc(ppayload) != p["crc"]:
            why_not[i] = f"parity group {g} payload failed its CRC"
            continue
        surviving = []
        usable = True
        for j in group:
            if j == i:
                continue
            b = blocks[j]
            if not b.get("ok", True) or b["csize"] > p["plen"]:
                why_not[i] = f"block {j}'s stored payload is unreadable"
                usable = False
                break
            surviving.append(frame[b["offset"]: b["offset"] + b["csize"]])
        if not usable:
            continue
        b = blocks[i]
        payload = xor_bytes([ppayload] + surviving, p["plen"])[: b["csize"]]
        # Never trust a reconstruction: prove it by decoding + the normal
        # per-block size/CRC check.  Overlapping damage (parity AND a
        # survivor both flipped, CRCs colliding) fails here, not silently.
        try:
            if b["raw"]:
                data = payload
            else:
                data = _decode_one(payload, b["usize"],
                                   engine.two_phase, False)
            check_block(i, b["usize"], b["crc"], data)
        except LZ4FormatError as e:
            why_not[i] = f"reconstruction failed verification: {e}"
            continue
        rebuilt[i] = data
    return rebuilt, why_not


def salvage_frame(frame: bytes, engine=None) -> SalvageReport:
    """Decode every undamaged block of ``frame``; reconstruct what v6
    parity can prove; report the rest (module docstring has the layers).

    ``engine`` is the `LZ4DecodeEngine` whose executor runs the per-block
    decodes (default: the process-wide engine).  Raises `FrameError` only
    when there is no block table to salvage with (header too short, bad
    magic, unknown version).
    """
    from repro_torch.core.decode_engine import DecodeStats, default_decode_engine
    from repro_torch.core.frame import block_crc, scan_frame

    eng = engine or default_decode_engine()
    mark = eng._layout_mark()
    ob = eng._obs_on()
    sp = obs.span_factory(ob)
    with sp("salvage.total", bytes_in=len(frame)):
        info = scan_frame(frame)
        blocks = info["blocks"]
        notes = list(info["notes"])
        st = DecodeStats(bytes_in=len(frame), blocks=len(blocks))
        errors: dict[int, str] = {}
        failed: set[int] = set()
        for i, b in enumerate(blocks):
            if not b.get("ok", True):
                errors[i] = b["note"]
                failed.add(i)
        with sp("salvage.decode", blocks=len(blocks) - len(failed)):
            got, bad = _decode_blocks_capturing(
                eng, frame, blocks,
                [i for i in range(len(blocks)) if i not in failed], st)
        for i, (msg, _cause) in bad.items():
            errors[i] = msg
            failed.add(i)
        with sp("salvage.reconstruct", candidates=len(failed)):
            rebuilt, why_not = _reconstruct_from_parity(frame, info, failed,
                                                        eng)
        for i, data in rebuilt.items():
            got[i] = data
            failed.discard(i)
            errors[i] += " (reconstructed from parity)"
        for i, why in why_not.items():
            errors[i] += f"; {why}"
        # Assemble: table-ordered content, zero-filling losses; extend to
        # the header content_size when the table itself lost entries.
        parts, holes, pos = [], [], 0
        for i, b in enumerate(blocks):
            u = b["usize"]
            if i in got:
                parts.append(got[i])
            else:
                parts.append(b"\x00" * u)
                holes.append((pos, pos + u))
            pos += u
        if info["content_size"] is not None and pos < info["content_size"]:
            missing = info["content_size"] - pos
            parts.append(b"\x00" * missing)
            holes.append((pos, pos + missing))
            notes.append(f"zero-filled {missing} bytes past the readable "
                         "table (lost entries)")
        data = b"".join(parts)
        merged: list[tuple[int, int]] = []
        for s, e in holes:
            if merged and merged[-1][1] == s:
                merged[-1] = (merged[-1][0], e)
            else:
                merged.append((s, e))
        lost = sorted(failed)
        crc_ok = None
        if info["content_crc"] is not None and not lost \
                and len(got) == info["block_count"]:
            crc_ok = block_crc(data) == info["content_crc"]
        ok = sorted(set(got) - set(rebuilt))
        if ob:
            r = obs.registry()
            r.counter("resilience.salvage_calls", "salvage passes").inc()
            r.counter("resilience.salvaged_blocks",
                      "blocks recovered clean by salvage").inc(len(ok))
            r.counter("resilience.reconstructed_blocks",
                      "blocks rebuilt from v6 parity").inc(len(rebuilt))
            r.counter("resilience.lost_blocks",
                      "blocks salvage could not recover").inc(len(lost))
        st.bytes_out = len(data)
        eng._finish_call(st, 0, mark)
        return SalvageReport(
            data=data, block_count=info["block_count"], ok=ok,
            reconstructed=sorted(rebuilt), lost=lost, holes=merged,
            errors=errors, notes=notes, content_crc_ok=crc_ok,
        )
