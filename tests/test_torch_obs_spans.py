"""The spans inside the port's two engines, on the CPU: each span's parent,
thread and count per call, the time its parent's direct children take, and
that tracing changes no output and, when off, records nothing.

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
    return {"call": 1, "block": stats.blocks, "dispatch": stats.dispatches}[how]


def test_the_corpus_gives_several_dispatches():
    for key in ("compress", "decode"):
        assert runs()[key][1].dispatches >= 3


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
