"""The engines' consumers in the port — checkpoints, the token pipeline,
KV-cache offload and gradient frames — held against the JAX package's
`repro.checkpoint`, `repro.data.pipeline`, `repro.serving.engine` and
`repro.optim.grad_compress` on the same seeded inputs, tolerance zero:
the same bytes on disk and on the wire (data.bin, manifest.json, shard
files, offload frames, gradient frames), each package restoring the
other's, and the same arrays, reports and counters.  Both packages run on
the CPU: the port through `device="cpu"` engines (the kernels' plain
versions).
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.checkpoint import checkpoint as jckpt
from repro.core import LZ4Engine as JaxEngine
from repro.data import pipeline as jpipe
from repro.optim import grad_compress as jgrad
from repro.resilience import inject as jinject
from repro.serving import engine as jserve
from repro_torch import FrameFormatError, LZ4DecodeEngine, LZ4Engine, frame_info
from repro_torch import obs as tobs
from repro_torch._tree import flatten
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.data import pipeline as tpipe
from repro_torch.optim import grad_compress as tgrad
from repro_torch.resilience.inject import InjectedCrash, corrupt_frame_block, flip_bits
from repro_torch.serving import engine as tserve

from test_torch_util import chaos  # noqa: F401  (fixture)


def _engine(**kw) -> LZ4Engine:
    # The associative select writes the same frames as the sequential one
    # and is several times faster through the plain versions.
    return LZ4Engine(device="cpu", scan_impl="associative", **kw)


def _decoder(**kw) -> LZ4DecodeEngine:
    return LZ4DecodeEngine(device="cpu", **kw)


@pytest.fixture
def both_obs():
    was = (tobs.is_enabled(), jobs.is_enabled())
    for o in (tobs, jobs):
        o.configure(enabled=True)
        o.reset()
    yield
    for o, w in zip((tobs, jobs), was):
        o.reset()
        o.configure(enabled=w)


def _bf16_bits(x: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16 bits (int16), rounded by JAX."""
    return np.asarray(jnp.asarray(x, jnp.bfloat16)).view(np.int16)


def np_tree(seed: int = 0) -> dict:
    """The one tree both packages save: float32, int32, uint8 and bfloat16
    leaves, a nested list with a None, and an int32 scalar.  bfloat16 is
    held as its bits."""
    rng = np.random.default_rng(seed)
    return {
        "a": rng.normal(0, 1, (64, 64)).astype(np.float32),
        "w": np.zeros((40_000,), np.float32),              # compressible
        "opt": {"r": rng.integers(0, 255, 5000).astype(np.uint8),
                "i": [rng.integers(-900, 900, (50, 40)).astype(np.int32), None]},
        "h": _bf16_bits(rng.normal(0, 1, (32, 64)).astype(np.float32)),
        "step": np.int32(7 + seed),
    }


def as_jax(t: dict):
    return {"a": jnp.asarray(t["a"]), "w": jnp.asarray(t["w"]),
            "opt": {"r": jnp.asarray(t["opt"]["r"]),
                    "i": [jnp.asarray(t["opt"]["i"][0]), None]},
            "h": jnp.asarray(t["h"].view(jnp.bfloat16)),
            "step": jnp.asarray(t["step"])}


def as_torch(t: dict):
    return {"a": torch.from_numpy(t["a"].copy()), "w": torch.from_numpy(t["w"].copy()),
            "opt": {"r": torch.from_numpy(t["opt"]["r"].copy()),
                    "i": [torch.from_numpy(t["opt"]["i"][0].copy()), None]},
            "h": torch.from_numpy(t["h"].copy()).view(torch.bfloat16),
            "step": torch.tensor(int(t["step"]), dtype=torch.int32)}


def bits(x) -> np.ndarray:
    """Any leaf (torch, jax, numpy) -> numpy array of its raw bits."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return x.cpu().numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def assert_trees_equal(got, want) -> None:
    gl, wl = flatten(got)[0], flatten(want)[0]
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        g, w = bits(g), bits(w)
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def small_tree(seed: int = 0) -> dict:
    """A tree with one engine-compressed leaf (the rest under 1024 bytes,
    stored raw): the crash-seam tests save it many times."""
    rng = np.random.default_rng(seed)
    return {"w": torch.zeros(2048), "b": torch.from_numpy(
        rng.normal(0, 1, 64).astype(np.float32)), "step": torch.tensor(seed)}


def save(d, step, tree, **kw):
    return ckpt.save(str(d), step, tree, engine=_engine(), **kw)


def restore(d, step, like, **kw):
    return ckpt.restore(str(d), step, like, decode_engine=_decoder(), **kw)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ckpt_dirs(tmp_path_factory):
    """The same tree saved by each package: {"port": dir, "jax": dir}."""
    root = tmp_path_factory.mktemp("ckpt")
    t = np_tree()
    ckpt.save(str(root / "port"), 3, as_torch(t), engine=_engine())
    jckpt.save(str(root / "jax"), 3, as_jax(t))
    return {"port": root / "port", "jax": root / "jax"}


def test_checkpoint_bytes_equal_reference(ckpt_dirs):
    for name in ("data.bin", "manifest.json"):
        port = (ckpt_dirs["port"] / "ckpt_3" / name).read_bytes()
        assert port == (ckpt_dirs["jax"] / "ckpt_3" / name).read_bytes(), name
    man = json.loads((ckpt_dirs["port"] / "ckpt_3" / "manifest.json").read_text())
    assert [e["path"] for e in man["leaves"]] == ["/a", "/h", "/opt/i/0", "/opt/r",
                                                 "/step", "/w"]
    assert {e["dtype"] for e in man["leaves"]} == {"float32", "bfloat16", "int32",
                                                  "uint8"}
    assert any(b["lz4"] for e in man["leaves"] for b in e["blocks"])


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_restores_across_packages(ckpt_dirs, writer):
    t = np_tree()
    like = {k: v for k, v in as_torch(np_tree(seed=5)).items()}
    got, step = restore(ckpt_dirs[writer], 3, like)
    assert step == 3
    assert_trees_equal(got, as_torch(t))
    assert got["h"].dtype == torch.bfloat16 and got["step"].shape == ()
    assert all(x.device.type == "cpu" for x in flatten(got)[0])
    jgot, jstep = jckpt.restore(str(ckpt_dirs[writer]), 3, as_jax(np_tree(seed=5)))
    assert jstep == 3
    assert_trees_equal(got, jgot)


def test_restore_like_placeholders_and_refusals(ckpt_dirs):
    meta = {k: v.to("meta") if isinstance(v, torch.Tensor) else v
            for k, v in as_torch(np_tree()).items()}
    meta["opt"] = {"r": torch.empty(5000, dtype=torch.uint8, device="meta"),
                   "i": [torch.empty((50, 40), dtype=torch.int32, device="meta"), None]}
    with pytest.raises(RuntimeError, match="restores to the card"):
        restore(ckpt_dirs["port"], 3, meta)
    # shardings= (refused until ROADMAP A8 was ported) places the leaves:
    # over a CPU mesh even where `like` holds `meta` placeholders.  The
    # case against the reference is in tests/test_torch_distributed.py.
    from repro_torch._tree import tree_map
    from repro_torch.distributed.sharding import NamedSharding, P, single_device_mesh

    one = single_device_mesh("cpu")
    got, _ = restore(ckpt_dirs["port"], 3, meta,
                     shardings=tree_map(lambda _: NamedSharding(one, P()), meta))
    want, _ = restore(ckpt_dirs["port"], 3, as_torch(np_tree()))
    assert_trees_equal(got, want)
    with pytest.raises(ValueError, match="do not match"):
        restore(ckpt_dirs["port"], 3, as_torch(np_tree()), shardings={})
    with pytest.raises(TypeError):
        restore(ckpt_dirs["port"], 3, np_tree())
    with pytest.raises(ValueError, match="on_error"):
        restore(ckpt_dirs["port"], 3, as_torch(np_tree()), on_error="ignore")


def test_restore_strict_and_salvage_equal_reference(tmp_path):
    """Bits flipped in data.bin: strict restore refuses in both packages; a
    salvage restore zero-fills the same spans, reports the same damage and
    returns the same leaves."""
    t = np_tree()
    ckpt.save(str(tmp_path / "port"), 1, as_torch(t), engine=_engine())
    data = tmp_path / "port" / "ckpt_1" / "data.bin"
    data.write_bytes(flip_bits(data.read_bytes(), seed=4, n=3))
    with pytest.raises(ckpt.CheckpointError, match="failed their digest"):
        restore(tmp_path / "port", 1, as_torch(t))
    with pytest.raises(jckpt.CheckpointError, match="failed their digest"):
        jckpt.restore(str(tmp_path / "port"), 1, as_jax(t))
    rep, jrep = {}, {}
    got, _ = restore(tmp_path / "port", 1, as_torch(t), on_error="salvage", report=rep)
    jgot, _ = jckpt.restore(str(tmp_path / "port"), 1, as_jax(t), on_error="salvage",
                            report=jrep)
    assert rep == jrep and (rep["zero_filled"] or rep["crc_mismatch"])
    assert_trees_equal(got, jgot)


def test_salvage_restore_zero_fills_exactly_the_damaged_block(tmp_path):
    """One compressed block of a leaf corrupted: salvage zero-fills exactly
    that block's span and names it; every other byte is the original."""
    w = torch.from_numpy((np.arange(60_000) % 7).astype(np.float32))  # 4 blocks
    save(tmp_path, 1, {"w": w})
    man = json.loads((tmp_path / "ckpt_1" / "manifest.json").read_text())
    b = man["leaves"][0]["blocks"][2]
    assert b["lz4"]
    data = tmp_path / "ckpt_1" / "data.bin"
    data.write_bytes(flip_bits(data.read_bytes(), seed=1, n=3, start=b["offset"],
                               end=b["offset"] + b["size"]))
    rep = {}
    got, _ = restore(tmp_path, 1, {"w": torch.empty_like(w)}, on_error="salvage",
                     report=rep)
    assert rep == {"zero_filled": {"/w": [2]}, "crc_mismatch": ["/w"]}
    raw, want = got["w"].numpy().view(np.uint8), w.numpy().view(np.uint8)
    span = slice(2 * 65536, 3 * 65536)
    assert not raw[span].any()
    np.testing.assert_array_equal(np.delete(raw, np.arange(2 * 65536, 3 * 65536)),
                                  np.delete(want, np.arange(2 * 65536, 3 * 65536)))


def test_restore_with_fallback_and_counters(tmp_path, both_obs):
    for pkg in ("port", "jax"):
        d = tmp_path / pkg
        t1, t2 = np_tree(), np_tree(seed=1)
        if pkg == "port":
            save(d, 1, as_torch(t1))
            save(d, 2, as_torch(t2))
        else:
            jckpt.save(str(d), 1, as_jax(t1))
            jckpt.save(str(d), 2, as_jax(t2))
        got, step = ckpt.restore_with_fallback(str(d), as_torch(t1),
                                               decode_engine=_decoder())
        assert step == 2
        assert_trees_equal(got, as_torch(t2))
        data = d / "ckpt_2" / "data.bin"
        data.write_bytes(flip_bits(data.read_bytes(), seed=0, n=3))
        got, step = ckpt.restore_with_fallback(str(d), as_torch(t1),
                                               decode_engine=_decoder())
        assert step == 1
        assert_trees_equal(got, as_torch(t1))
        assert (d / "ckpt_2").exists()
        jckpt.restore_with_fallback(str(d), as_jax(t1))
    want = {"checkpoint.fallback_steps": 2, "checkpoint.fallback_restores": 2}
    for o in (tobs, jobs):
        c = o.snapshot()["metrics"]["counters"]
        assert {k: c[k] for k in want} == want
    data = tmp_path / "port" / "ckpt_1" / "data.bin"
    data.write_bytes(data.read_bytes()[:-5])
    with pytest.raises(ckpt.CheckpointError, match="no valid checkpoint found"):
        ckpt.restore_with_fallback(str(tmp_path / "port"), as_torch(np_tree()),
                                   decode_engine=_decoder())


@pytest.mark.parametrize("seam", ["checkpoint.data", "checkpoint.manifest",
                                  "checkpoint.rename"])
def test_kill_in_the_middle_never_tears_a_step(chaos, tmp_path, seam):
    tree = small_tree()
    save(tmp_path, 1, tree)
    inj = chaos(seed=3, crash_at=seam)
    with pytest.raises(InjectedCrash):
        save(tmp_path, 2, small_tree(seed=1))
    assert inj.crashes == [seam]
    assert ckpt.latest_step(str(tmp_path)) == 1
    got, step = ckpt.restore_with_fallback(str(tmp_path), tree,
                                           decode_engine=_decoder())
    assert step == 1
    assert_trees_equal(got, tree)
    tree2 = small_tree(seed=1)
    save(tmp_path, 2, tree2)
    assert not os.path.exists(tmp_path / "ckpt_2.tmp")
    assert ckpt.latest_step(str(tmp_path)) == 2
    got, _ = restore(tmp_path, 2, tree2)
    assert_trees_equal(got, tree2)


def test_crash_after_rename_keeps_new_step(chaos, tmp_path):
    tree = small_tree()
    save(tmp_path, 1, tree)
    chaos(seed=0, crash_at="checkpoint.cleanup")
    with pytest.raises(InjectedCrash):
        save(tmp_path, 2, tree)
    assert ckpt.latest_step(str(tmp_path)) == 2
    got, step = restore(tmp_path, 2, tree)
    assert step == 2
    assert_trees_equal(got, tree)


def test_transient_io_retried_and_torn_data(chaos, tmp_path, both_obs):
    tree = small_tree()
    save(tmp_path, 2, tree)
    inj = chaos(seed=0, fail={"checkpoint.open": 1, "checkpoint.read": 2})
    got, step = restore(tmp_path, 2, tree)
    assert step == 2
    assert_trees_equal(got, tree)
    assert sorted(inj.io_faults) == ["checkpoint.open", "checkpoint.read",
                                     "checkpoint.read"]
    assert tobs.snapshot()["metrics"]["counters"]["resilience.retries"] == 3
    data = tmp_path / "ckpt_2" / "data.bin"
    data.write_bytes(data.read_bytes()[:-7])
    with pytest.raises(ckpt.CheckpointError, match="data.bin is") as ei:
        restore(tmp_path, 2, tree)
    assert ei.value.cause == "truncated"


def test_async_save_is_a_snapshot(chaos, tmp_path):
    """The writer thread is held back (an injected stall at its first file
    open) while the caller updates the tensor in place: the checkpoint holds
    the values at the time `save` returned."""
    state = {"w": torch.zeros(50_000), "m": torch.arange(4000, dtype=torch.float32)}
    want = {k: v.clone() for k, v in state.items()}
    chaos(seed=0, slow={"checkpoint.open": 0.3})
    th = save(tmp_path, 1, state, async_write=True)
    state["w"].add_(1.0)
    state["m"].mul_(-1.0)
    th.join(timeout=120)
    assert not th.is_alive()
    got, _ = restore(tmp_path, 1, {k: torch.empty_like(v) for k, v in state.items()})
    assert_trees_equal(got, want)


# ---------------------------------------------------------------------------
# the token pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cache_shards", [True, False])
def test_pipeline_shards_and_batches_equal_reference(tmp_path, cache_shards):
    kw = dict(n_shards=2, shard_tokens=40_000, seed=3, cache_shards=cache_shards)
    port = tpipe.ShardedTokenPipeline(str(tmp_path / "port"), 1000, engine=_engine(),
                                      decode_engine=_decoder(), **kw)
    ref = jpipe.ShardedTokenPipeline(str(tmp_path / "jax"), 1000, **kw)
    for a, b in zip(port.shards, ref.shards):
        assert open(a, "rb").read() == open(b, "rb").read()
    # The port reading the reference's shard files.
    reader = tpipe.ShardedTokenPipeline(str(tmp_path / "jax"), 1000,
                                        decode_engine=_decoder(), **kw)
    for step in range(3):
        got = port.batch(step, 4, 64)
        assert isinstance(got, np.ndarray) and got.dtype == np.int32
        np.testing.assert_array_equal(got, ref.batch(step, 4, 64))
        np.testing.assert_array_equal(reader.batch(step, 4, 64), got)
    assert port.compression_ratio() == ref.compression_ratio() > 1
    np.testing.assert_array_equal(tpipe.synth_tokens(9, 5000, 300),
                                  jpipe.synth_tokens(9, 5000, 300))


# ---------------------------------------------------------------------------
# KV-cache offload
# ---------------------------------------------------------------------------

def np_cache() -> dict:
    rng = np.random.default_rng(11)
    return {"k": rng.normal(0, 1, (40, 2048)).astype(np.float32),
            "v": np.zeros((30, 2048), np.float32),
            "h": _bf16_bits(rng.normal(0, 1, (8, 512)).astype(np.float32)),
            "pos": np.arange(37, dtype=np.int32),
            "none": None}


def cache_jax(c):
    return {"k": jnp.asarray(c["k"]), "v": jnp.asarray(c["v"]),
            "h": jnp.asarray(c["h"].view(jnp.bfloat16)), "pos": jnp.asarray(c["pos"]),
            "none": None}


def cache_torch(c):
    return {"k": torch.from_numpy(c["k"].copy()), "v": torch.from_numpy(c["v"].copy()),
            "h": torch.from_numpy(c["h"].copy()).view(torch.bfloat16),
            "pos": torch.from_numpy(c["pos"].copy()), "none": None}


@pytest.fixture(scope="module")
def blobs():
    """(port blob, reference blob) of the same cache."""
    c = np_cache()
    port, pstats = tserve.offload_cache(cache_torch(c), engine=_engine())
    ref, rstats = jserve.offload_cache(cache_jax(c))
    assert pstats == rstats
    return port, ref


def test_offload_frames_equal_reference(blobs):
    port, ref = blobs
    assert len(port[1]) == len(ref[1]) == 4
    for p, r in zip(port[1], ref[1]):
        assert p["frame"] == r["frame"]
        assert tuple(p["shape"]) == tuple(r["shape"]) and p["dtype"] == r["dtype"]
    assert [b["dtype"] for b in port[1]] == ["bfloat16", "float32", "int32", "float32"]


@pytest.mark.parametrize("to_device", [False, True])
def test_restore_cache_equal_reference(blobs, to_device):
    port, ref = blobs
    eng = _decoder(plan_on_device=to_device)
    got = tserve.restore_cache(port, eng, to_device=to_device)
    assert_trees_equal(got, cache_torch(np_cache()))
    assert got["none"] is None
    assert_trees_equal(got, jserve.restore_cache(ref, to_device=to_device))
    if to_device:
        assert eng.stats.host_bytes == 0
        # a view of the decoded uint8 tensor, not a copy
        assert got["k"]._is_view()
        u8 = torch.arange(64, dtype=torch.uint8)
        v = tserve._device_view(u8, "bfloat16", (4, 8))
        assert v.untyped_storage().data_ptr() == u8.untyped_storage().data_ptr()
    rdr = tserve.OffloadedCacheReader(port, _decoder(), to_device=to_device)
    jrdr = jserve.OffloadedCacheReader(ref, to_device=to_device)
    assert len(rdr) == 4
    for i, (start, count) in enumerate([(100, 300), (64, 32), (0, 37), (60000, 900)]):
        assert bits(rdr.read_leaf(i, start, count)).tobytes() == \
            bits(jrdr.read_leaf(i, start, count)).tobytes()
    assert_trees_equal(rdr.restore(), got)
    with pytest.raises(ValueError, match="outside leaf"):
        rdr.read_leaf(2, 30, 10)


def _damaged(blobs, parity: bool, block: int, seed: int):
    """Both packages' blobs with leaf 1 ("k") re-framed (v6 with parity when
    asked) and one block corrupted; the corrupted frames are equal."""
    out = []
    raw = np_cache()["k"].tobytes()
    for blob, eng, corrupt in ((blobs[0], _engine, corrupt_frame_block),
                               (blobs[1], JaxEngine, jinject.corrupt_frame_block)):
        leaves = [dict(b) for b in blob[1]]
        frame = eng(parity_group=4).compress(raw) if parity else leaves[1]["frame"]
        leaves[1]["frame"] = corrupt(frame, block, seed=seed, n=3)
        out.append([blob[0], leaves])
    assert out[0][1][1]["frame"] == out[1][1][1]["frame"]
    return out


@pytest.mark.parametrize("case", ["no_parity", "parity", "parity_to_device"])
def test_restore_cache_salvage_equal_reference(blobs, case):
    block, seed = {"no_parity": (0, 0), "parity": (1, 0), "parity_to_device": (0, 1)}[case]
    port, ref = _damaged(blobs, parity=case != "no_parity", block=block, seed=seed)
    to_device = case == "parity_to_device"
    with pytest.raises(FrameFormatError):
        tserve.restore_cache(port, _decoder(), to_device=to_device)
    rep, jrep = {}, {}
    got = tserve.restore_cache(port, _decoder(), to_device=to_device,
                               on_error="salvage", report=rep)
    want = jserve.restore_cache(ref, to_device=to_device, on_error="salvage",
                                report=jrep)
    assert set(rep) == set(jrep) == {1}
    for f in ("data", "ok", "reconstructed", "lost", "holes", "errors", "notes",
              "content_crc_ok"):
        assert getattr(rep[1], f) == getattr(jrep[1], f), f
    assert_trees_equal(got, want)
    if case == "no_parity":
        assert rep[1].lost == [0]
        np.testing.assert_array_equal(got["v"].numpy(), np_cache()["v"])
    else:
        assert rep[1].complete
        assert_trees_equal(got, cache_torch(np_cache()))


def test_offloaded_reader_salvage_leaf(blobs):
    port, ref = _damaged(blobs, parity=False, block=1, seed=2)
    with pytest.raises(ValueError, match="on_error"):
        tserve.OffloadedCacheReader(port, _decoder(), on_error="nope")
    rdr = tserve.OffloadedCacheReader(port, _decoder(), on_error="salvage")
    jrdr = jserve.OffloadedCacheReader(ref, on_error="salvage")
    rep, jrep = rdr.salvage_leaf(1), jrdr.salvage_leaf(1)
    assert rep.lost == jrep.lost == [1] and rep.data == jrep.data
    assert rdr.leaf_meta(1) == ((40, 2048), "float32")
    np.testing.assert_array_equal(rdr.read_leaf(3, start=64, count=32).numpy(),
                                  np_cache()["v"].reshape(-1)[64:96])
    # reads inside the damaged leaf's intact blocks still work
    np.testing.assert_array_equal(rdr.read_leaf(1, 0, 100).numpy(),
                                  np_cache()["k"].reshape(-1)[:100])
    with pytest.raises(FrameFormatError):
        rdr.read_leaf(1, 20000, 10)


# ---------------------------------------------------------------------------
# gradient frames and the error-feedback quantizer
# ---------------------------------------------------------------------------

def np_grads(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {"w": (rng.normal(0, 1e-3, (96, 256)) * rng.random((96, 256)) ** 4
                  ).astype(np.float32),
            "b": rng.normal(0, 1, 300).astype(np.float32),
            "e": _bf16_bits(rng.normal(0, 0.02, (64, 64)).astype(np.float32)),
            "z": np.zeros(5, np.float32)}


def grads_torch(g):
    return {"w": torch.from_numpy(g["w"].copy()), "b": torch.from_numpy(g["b"].copy()),
            "e": torch.from_numpy(g["e"].copy()).view(torch.bfloat16),
            "z": torch.from_numpy(g["z"].copy())}


def grads_jax(g):
    return {"w": jnp.asarray(g["w"]), "b": jnp.asarray(g["b"]),
            "e": jnp.asarray(g["e"].view(jnp.bfloat16)), "z": jnp.asarray(g["z"])}


def test_gradient_frames_equal_reference():
    g = np_grads()
    frame = tgrad.export_gradient_frame(grads_torch(g), engine=_engine())
    assert frame == jgrad.export_gradient_frame(grads_jax(g))
    like = {k: torch.empty_like(v) for k, v in grads_torch(np_grads(1)).items()}
    got = tgrad.import_gradient_frame(frame, like, decode_engine=_decoder())
    assert_trees_equal(got, grads_torch(g))
    assert_trees_equal(got, jgrad.import_gradient_frame(frame, grads_jax(g)))
    with pytest.raises(ValueError, match="pytree expects"):
        tgrad.import_gradient_frame(frame, {"w": like["w"]}, decode_engine=_decoder())
    with pytest.raises(RuntimeError, match="restores to the card"):
        tgrad.import_gradient_frame(
            frame, {k: v.to("meta") for k, v in like.items()}, decode_engine=_decoder())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_with_error_feedback_equal_reference(dtype):
    """Three steps of int8 quantization with error feedback: dequantized
    gradients and residuals equal XLA's bit for bit (float32 arithmetic in
    the same order; round half to even in both)."""
    tg, jg = grads_torch(np_grads()), grads_jax(np_grads())
    if dtype == "float32":
        tg["e"], jg["e"] = tg["e"].float(), jg["e"].astype(jnp.float32)
    else:
        tg = {k: v.to(torch.bfloat16) for k, v in tg.items()}
        jg = {k: v.astype(jnp.bfloat16) for k, v in jg.items()}
    tef, jef = tgrad.ef_init(tg), jgrad.ef_init(jg)
    assert_trees_equal(tef, jef)
    for step in range(3):
        tout, tef = tgrad.quantize_with_error_feedback(tg, tef)
        jout, jef = jgrad.quantize_with_error_feedback(jg, jef)
        assert_trees_equal(tout, jout)
        assert_trees_equal(tef, jef)
        assert all(v.dtype == tg[k].dtype for k, v in tout.items())
        tg = {k: v * 0.5 for k, v in tg.items()}
        jg = {k: v * 0.5 for k, v in jg.items()}
    assert_trees_equal(tgrad.ef_init(tg), jgrad.ef_init(jg))
