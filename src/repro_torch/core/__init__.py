"""Core LZ4 library of the port — the write path, the read path and the
NumPy golden models.

Public API:
    compress_greedy      — multi-match software LZ4 baseline (host, NumPy)
    compress_windowed    — the paper's single-match windowed golden model
                           (S1, S1+S2); compress_windowed_multi — the
                           multi-match windowed model of the cycle analysis
    encode_block         — exact LZ4 encoder of a sequence plan (host oracle)
    LZ4Engine            — batched compression pipeline (frame out); with
                           ``device_emit=True`` (default) byte emission stays
                           on the device and only final frame bytes cross
                           the host boundary; ``candidate_impl`` picks the
                           fused datapath (default) or the staged one
    default_engine       — process-wide shared LZ4Engine
    emit_block           — host-side vectorized (prefix-sum) block emission:
                           the engine's ``device_emit=False`` path and the
                           oracle for the device emitter
    decode_block         — exact LZ4 block decoder (host)
    encode_frame / decode_frame — self-describing multi-block container
                           (byte-level spec: docs/frame-format.md)
    decode_frame_serial  — serial block-walk decoder (the oracle)
    LZ4DecodeEngine      — two-phase frame decoder; the device executor
                           (default, on the card) plans on the host or, with
                           ``plan_on_device=True``, on the device, and
                           `decode_to_device` keeps the plaintext there
    DecodeStats          — its per-call / lifetime counters
    FrameReader          — random access through the frame's block table
"""
from .lz4_types import (  # noqa: F401
    DEFAULT_HASH_BITS,
    DEFAULT_MAX_MATCH,
    DEFAULT_PWS,
    MAX_BLOCK,
    Sequence,
    plan_coverage,
    plan_size,
)
from .reference import compress_greedy, compression_ratio  # noqa: F401
from .schemes import compress_windowed, compress_windowed_multi  # noqa: F401
from .encoder import encode_block  # noqa: F401
from .decoder import decode_block, decode_block_bytewise, LZ4FormatError  # noqa: F401
from .emitter import emit_block, emit_block_from_records  # noqa: F401
from .frame import (  # noqa: F401
    VERSION_V1,
    VERSION_V2,
    VERSION_V3,
    VERSION_V4,
    VERSION_V5,
    VERSION_V6,
    FrameFormatError,
    block_crc,
    check_content_crc,
    decode_frame,
    decode_frame_serial,
    encode_frame,
    frame_info,
    parity_group_blocks,
    scan_frame,
    xor_bytes,
)
from .engine import EngineStats, LZ4Engine, default_engine  # noqa: F401
from .compressor import (  # noqa: F401
    CANDIDATE_IMPLS,
    BlockRecords,
    compress_block_bytes,
    compress_block_records,
    compress_blocks_bytes,
    compress_blocks_records,
    resolve_candidate_impl,
)
from .corpus import corpus_blocks, corpus_files  # noqa: F401
from .decode_plan import (  # noqa: F401
    BlockPlan,
    DevicePlan,
    DevicePlanCaps,
    DevicePlanOverflow,
    MAX_RESOLVE_ROUNDS,
    decode_block_planned,
    execute_device_plan,
    execute_plan,
    plan_block,
    plan_block_fast,
    to_device_plan,
)
from .decode_engine import (  # noqa: F401
    DecodeStats,
    FrameReader,
    LZ4DecodeEngine,
    default_decode_engine,
)
