"""The spans inside the port's two engines, on the CPU: each span's parent,
thread and count per call, the time its parent's direct children take, and
that tracing changes no output and, when off, records nothing.  Also
`serving.restore_cache`'s counters and the decode engine's
``decode.raw_bytes`` on a restore to the device.

Spans in functions the engines call (`compressor.compress_blocks_bytes`) come
through the engine's own span factory, so an engine with ``telemetry=True``
records them with the global switch off.  The catalog is docs/torch-port.md's
"Spans" section.
"""
from __future__ import annotations

import functools
import threading

import pytest
import torch

from repro_torch import LZ4DecodeEngine, LZ4Engine, obs
from repro_torch.core.frame import MAX_BLOCK, frame_info
from repro_torch.serving import engine as serving

from test_torch_util import multiblock_corpus

# name: (parent, how often a call records it)
COMPRESS_SPANS = {
    "compress.split": ("compress.total", "call"),
    "compress.crc": ("compress.total", "block"),
    "compress.candidates": ("compress.dispatch", "dispatch"),
    "compress.select": ("compress.dispatch", "dispatch"),
    "compress.emit": ("compress.dispatch", "dispatch"),
}
DECODE_SPANS = {
    "decode.split": ("decode.total", "call"),
    "decode.stack": ("decode.total", "dispatch"),
    "decode.upload": ("decode.plan_device", "dispatch"),
    "decode.wait": ("decode.total", "dispatch"),
    "decode.finish": ("decode.total", "dispatch"),
    "decode.join": ("decode.total", "call"),
    "decode.raw": ("decode.split", "raw block"),
}
SPANS = {**COMPRESS_SPANS, **DECODE_SPANS}
MICRO_BATCH = 1      # 5 compress and 4 decode dispatches for the 5-block corpus


def compress_engine(telemetry: bool) -> LZ4Engine:
    return LZ4Engine(device="cpu", scan_impl="associative",
                     micro_batch=MICRO_BATCH, telemetry=telemetry)


def decode_engine(telemetry: bool) -> LZ4DecodeEngine:
    return LZ4DecodeEngine(device="cpu", plan_on_device=True,
                           micro_batch=MICRO_BATCH, telemetry=telemetry)


def recorded(call):
    """(call's result, the spans it recorded)."""
    obs.reset()
    try:
        out = call()
        return out, obs.tracer().finished()
    finally:
        obs.reset()


@functools.lru_cache(maxsize=1)
def runs() -> dict:
    """One traced compress and one traced decode of the corpus, beside the
    same calls untraced."""
    data = multiblock_corpus()
    plain = compress_engine(False).compress(data)
    eng = compress_engine(True)
    frame, c_rows = recorded(lambda: eng.compress(data))
    dec = decode_engine(True)
    out, d_rows = recorded(lambda: dec.decode_to_device(frame, verify=True))
    return dict(data=data, plain=plain, frame=frame, out=out,
                plain_out=decode_engine(False).decode_to_device(frame),
                compress=(c_rows, eng.stats), decode=(d_rows, dec.stats),
                tid=threading.get_ident())


def rows_and_stats(name: str):
    return runs()["compress" if name.startswith("compress.") else "decode"]


def per_call(how: str, stats) -> int:
    return {"call": 1, "block": stats.blocks, "dispatch": stats.dispatches,
            "raw block": stats.raw_blocks}[how]


def test_the_corpus_gives_several_dispatches():
    for key in ("compress", "decode"):
        assert runs()[key][1].dispatches >= 3
    assert runs()["decode"][1].raw_blocks == 1


def test_a_raw_blocks_crc_sits_inside_its_decode_raw():
    rows, stats = runs()["decode"]
    raw = [r for r in rows if r["name"] == "decode.raw"]
    crcs = [r for r in rows if r["name"] == "decode.verify" and r["args"].get("raw")]
    assert [r["args"]["bytes"] for r in raw] == [MAX_BLOCK]
    assert len(crcs) == stats.raw_blocks
    assert {r["parent"] for r in crcs} == {"decode.raw"}


@pytest.mark.parametrize("name", sorted(SPANS))
def test_span_sits_where_the_catalog_says(name):
    parent, how = SPANS[name]
    rows, stats = rows_and_stats(name)
    mine = [r for r in rows if r["name"] == name]
    assert mine, f"{name} not recorded"
    assert {r["parent"] for r in mine} == {parent}
    assert {r["tid"] for r in mine} == {runs()["tid"]}
    assert len(mine) == per_call(how, stats)
    # Each lies inside one of its parent's spans, one level below it.
    parents = [r for r in rows if r["name"] == parent]
    for r in mine:
        assert any(p["start_ns"] <= r["start_ns"]
                   and r["start_ns"] + r["dur_ns"] <= p["start_ns"] + p["dur_ns"]
                   and r["depth"] == p["depth"] + 1 for p in parents)


@pytest.mark.parametrize("parent", ["compress.total", "compress.dispatch",
                                    "decode.total", "decode.plan_device"])
def test_direct_children_fit_inside_their_parent(parent):
    rows, _ = rows_and_stats(parent)
    for p in (r for r in rows if r["name"] == parent):
        end = p["start_ns"] + p["dur_ns"]
        children = [r for r in rows if r["parent"] == parent
                    and r["depth"] == p["depth"] + 1
                    and p["start_ns"] <= r["start_ns"] <= end]
        assert children
        assert sum(r["dur_ns"] for r in children) <= p["dur_ns"]


def test_outputs_are_the_same_traced_or_not():
    r = runs()
    assert r["frame"] == r["plain"]
    want = torch.frombuffer(bytearray(r["data"]), dtype=torch.uint8)
    assert torch.equal(r["out"], want) and torch.equal(r["plain_out"], want)


def cache_tree() -> dict:
    """A cache-like tree: a bfloat16 leaf of a noise block (stored raw) and
    a zero block (coded), an int32 leaf and a tiny one (a raw frame)."""
    g = torch.Generator().manual_seed(7)
    kv = torch.zeros(2, MAX_BLOCK // 2, dtype=torch.bfloat16)
    kv[0] = torch.randn(MAX_BLOCK // 2, generator=g).to(torch.bfloat16)
    return {"k": kv, "pos": torch.arange(4096, dtype=torch.int32),
            "step": torch.tensor(3, dtype=torch.int32)}


def restored(enabled: bool):
    """(the tree, its frames' blocks, the counters, the span names) of one
    `restore_cache` to the device with the global switch at ``enabled``."""
    tree = cache_tree()
    blob, _ = serving.offload_cache(tree, engine=compress_engine(False))
    was = obs.is_enabled()
    obs.configure(enabled=enabled)
    try:
        obs.reset()
        out = serving.restore_cache(blob, decode_engine(None), to_device=True)
        counters = dict(obs.snapshot()["metrics"]["counters"])
        names = {r["name"] for r in obs.tracer().finished()}
    finally:
        obs.reset()
        obs.configure(enabled=was)
    for k, v in tree.items():
        assert out[k].dtype == v.dtype and torch.equal(out[k], v)
    blocks = [b for leaf in blob[1] for b in frame_info(leaf["frame"])["blocks"]]
    return tree, blocks, counters, names


def test_restore_counts_leaves_bytes_and_raw_bytes():
    tree, blocks, counters, names = restored(True)
    raw = [b["usize"] for b in blocks if b["raw"]]
    # At least the noise half of "k" and the 4-byte frame of "step" are raw,
    # and the zero half of "k" is coded.
    assert MAX_BLOCK in raw and 4 in raw and len(raw) < len(blocks)
    assert counters["serving.restores"] == 1
    assert counters["serving.restore_leaves"] == len(tree) == 3
    assert counters["serving.restore_bytes"] == MAX_BLOCK * 2 + 4096 * 4 + 4
    assert counters["decode.raw_blocks"] == len(raw)
    assert counters["decode.raw_bytes"] == sum(raw)
    assert {"serving.restore", "decode.raw"} <= names


def test_restore_records_nothing_with_telemetry_off():
    _, _, counters, names = restored(False)
    assert counters == {} and names == set()


def test_nothing_is_recorded_with_telemetry_off():
    was = obs.is_enabled()
    obs.configure(enabled=False)
    try:
        r = runs()
        frame, rows = recorded(lambda: compress_engine(False).compress(r["data"]))
        assert frame == r["plain"] and rows == []
        _, rows = recorded(lambda: decode_engine(False).decode_to_device(frame))
        assert rows == []
    finally:
        obs.configure(enabled=was)
