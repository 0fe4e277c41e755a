"""`FrameError` — the root of the repo's corruption-error hierarchy.

Before the resilience layer, the read stack raised a mix of types that
callers had to string-match: block parse errors were `LZ4FormatError`
(a bare ValueError subclass), frame/table/CRC errors `FrameFormatError`,
and checkpoint corruption a `CheckpointError(RuntimeError)` wrapping the
others' messages.  `FrameError` unifies them:

    FrameError                      (this module; carries block_index/cause)
      LZ4FormatError(ValueError)    (core/decoder.py — block parse errors)
        FrameFormatError            (core/frame.py — frame/table/CRC errors)
      CheckpointError(RuntimeError) (checkpoint/checkpoint.py)

Every pre-existing `except ValueError` / `except RuntimeError` site keeps
working (the legacy bases are retained via multiple inheritance), and every
corruption path — parse, CRC, truncation, checkpoint — is now catchable as
one type with structured attributes instead of message matching:

    try:
        engine.decode(frame)
    except FrameError as e:
        print(e.block_index, e.cause)   # e.g. 3, "crc"

``block_index`` is the 0-based frame/leaf block the error was attributed
to (None for whole-frame errors: header, table, content trailer).
``cause`` is a short machine-readable slug — the salvage layer
(`repro.resilience.salvage`) groups per-block failures by it:

    "truncated"    payload/table/header bytes missing
    "parse"        token stream does not parse as LZ4
    "size"         decoded size disagrees with the table/manifest
    "crc"          per-block content CRC32 mismatch
    "content_crc"  whole-object (v5+) trailer mismatch
    "structure"    frame/table structure invalid (magic, version, flags)

Error MESSAGES are unchanged everywhere — tests pin them — the hierarchy
only adds attributes and a common base.

This module is dependency-free (stdlib only) so `repro.core.decoder` can
import it without cycling back through the resilience package's heavier
submodules (the package ``__init__`` loads those lazily).
"""
from __future__ import annotations

__all__ = ["FrameError"]


class FrameError(Exception):
    """Base class for every corruption/format error in the read stack.

    Subclasses keep their legacy bases (ValueError for the block/frame
    parsers, RuntimeError for checkpoints) so existing handlers and tests
    are unaffected; the attributes here are additive.
    """

    def __init__(self, *args, block_index: int | None = None,
                 cause: str | None = None):
        super().__init__(*args)
        self.block_index = block_index
        self.cause = cause

    def __reduce__(self):
        # Exceptions cross process-pool boundaries (the decode engine's
        # "process" executor): keep args + structured attributes through
        # pickling.  BaseException's default reduce already ships __dict__
        # as state, but only when the subclass __init__ accepts bare args —
        # which ours does — so this explicit form is just belt-and-braces
        # against subclasses overriding __init__ incompatibly.
        return (self.__class__, self.args,
                {"block_index": self.block_index, "cause": self.cause})

    def __setstate__(self, state):
        self.__dict__.update(state)
