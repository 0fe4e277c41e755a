"""The sharded compression fabric of the port (`repro_torch.distributed.fabric`)
against the JAX package's, on the CPU.

Host path: `LZ4Engine(shards=s, device="cpu")` against the reference's
`LZ4Engine(shards=s)` in this process.  Mesh path: meshes that repeat the CPU
(`make_mesh(shape, axes, devices=[cpu] * n)`) against the reference's meshes
of fake devices, run once per module in ONE subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` (as
`tests/test_distributed.py` does).  Frames are bytes and stats are counts:
tolerance zero.  The port compresses with ``scan_impl="associative"`` (the
same frames as the sequential select, faster on a CPU) and both packages
with ``candidate_impl="sortkey"``, so `EngineStats` agree field by field.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import LZ4DecodeEngine as JaxDecodeEngine
from repro.core import LZ4Engine as JaxEngine
from repro.core.frame import decode_frame_serial as jax_decode_serial
from repro.distributed import fabric as jfabric
from repro.distributed.sharding import single_device_mesh as jax_single_mesh
from repro_torch import (
    FrameFormatError,
    FrameReader,
    LZ4DecodeEngine,
    LZ4Engine,
    compat,
    decode_frame_serial,
    frame_info,
)
from repro_torch.core.decode_plan import DevicePlanCaps
from repro_torch.distributed import fabric
from repro_torch.distributed.sharding import make_mesh

from test_torch_util import MAX_BLOCK, corrupt_coded_block, fabric_corpus

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
PORT = dict(device="cpu", candidate_impl="sortkey", scan_impl="associative")
REF = dict(candidate_impl="sortkey")
MESH_SHAPES = [(1, 1), (2, 1), (2, 2), (1, 8)]
# Both planners on the device executor (the port's default; the reference's
# is "serial"), which a mesh of one shard takes instead of the fabric.
PLANNERS = {"host": dict(executor="device"),
            "spec": dict(executor="device", plan_on_device=True)}
SMALL_CAPS = 49152   # blk_cap under which some corpus payloads fall back

_REFERENCE = textwrap.dedent("""
    import json, os, sys
    import jax
    from repro.core.decode_engine import LZ4DecodeEngine
    from repro.core.decode_plan import DevicePlanCaps
    from repro.core.engine import LZ4Engine
    from repro.core.frame import FrameFormatError, frame_info
    from repro.distributed.sharding import make_mesh_compat
    from test_torch_util import corrupt_coded_block, fabric_corpus

    out_dir, small_caps = sys.argv[1], int(sys.argv[2])
    assert len(jax.devices()) == 8
    planners = {"host": dict(executor="device"),
                "spec": dict(executor="device", plan_on_device=True)}
    res = {}
    for shape in [(1, 1), (2, 1), (2, 2), (1, 8)]:
        mesh = make_mesh_compat(shape, ("data", "model"))
        S = shape[0] * shape[1]
        data = fabric_corpus(7, seed=S)
        eng = LZ4Engine(mesh=mesh, candidate_impl="sortkey")
        frame = eng.compress(data)
        with open(os.path.join(out_dir, f"mesh_{S}.bin"), "wb") as f:
            f.write(frame)
        r = {"engine": eng.stats.as_dict()}
        eng.compress_to_blocks(data)
        r["to_blocks"] = eng.stats.as_dict()
        info = frame_info(frame)
        payloads = [frame[b["offset"]: b["offset"] + b["csize"]]
                    for b in info["blocks"]]
        raws = [b["raw"] for b in info["blocks"]]
        usizes = [b["usize"] for b in info["blocks"]]
        for name, kw in planners.items():
            dec = LZ4DecodeEngine(mesh=mesh, micro_batch=2, **kw)
            assert dec.decode(frame) == data
            r["decode_" + name] = dec.stats.as_dict()
            assert b"".join(dec.decode_blocks(payloads, raws, usizes)) == data
            r["blocks_" + name] = dec.stats.as_dict()
            for head in (False, True):
                bad, _ = corrupt_coded_block(frame, info, head)
                try:
                    dec.decode(bad)
                    r[f"corrupt_{name}_{head}"] = None
                except FrameFormatError as e:
                    r[f"corrupt_{name}_{head}"] = str(e)
            small = LZ4DecodeEngine(mesh=mesh, micro_batch=2,
                                    caps=DevicePlanCaps(blk_cap=small_caps), **kw)
            assert small.decode(frame) == data
            r["small_" + name] = small.stats.as_dict()
        res[str(S)] = r
    print("RESULT:" + json.dumps(res))
""")


@pytest.fixture(scope="module")
def mesh_reference(tmp_path_factory):
    """The reference's mesh-path frames and stats, from one subprocess."""
    out = tmp_path_factory.mktemp("fabric_ref")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT / 'tests'}")
    proc = subprocess.run(
        [sys.executable, "-c", _REFERENCE, str(out), str(SMALL_CAPS)],
        capture_output=True, text=True, timeout=600, env=env, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [x for x in proc.stdout.splitlines() if x.startswith("RESULT:")][0]
    res = json.loads(line[len("RESULT:"):])
    for S in res:
        res[S]["frame"] = (out / f"mesh_{S}.bin").read_bytes()
    return res


def cpu_mesh(shape, axes=("data", "model")):
    return make_mesh(shape, axes, devices=[CPU] * int(np.prod(shape)))


def slices_of(data: bytes, shards: int):
    chunks = [data[i: i + MAX_BLOCK] for i in range(0, len(data), MAX_BLOCK)]
    return [b"".join(chunks[sl.start: sl.stop])
            for sl in fabric.partition_blocks(len(chunks), shards)]


# -- partition -----------------------------------------------------------------

@pytest.mark.parametrize("shards", range(1, 10))
def test_partition_blocks_equals_reference(shards):
    for n in range(21):
        got = fabric.partition_blocks(n, shards)
        want = jfabric.partition_blocks(n, shards)
        assert [(s.shard, s.start, s.stop, s.count) for s in got] == \
            [(s.shard, s.start, s.stop, s.count) for s in want]
    with pytest.raises(ValueError, match="shards must be >= 1"):
        fabric.partition_blocks(4, 0)


# -- host path -------------------------------------------------------------------

@pytest.mark.parametrize("n_blocks,shards", [(5, 1), (6, 2), (8, 4), (5, 2),
                                             (7, 4), (3, 8), (0, 2)])
def test_host_path_frame_and_stats_equal_reference(n_blocks, shards):
    """v4 frames byte-identical to the reference's, `EngineStats` field by
    field; uneven splits (5/2, 7/4, 3/8) and empty input included."""
    data = fabric_corpus(n_blocks, seed=n_blocks * 10 + shards) if n_blocks else b""
    eng = LZ4Engine(shards=shards, **PORT)
    frame = eng.compress(data)
    ref = JaxEngine(shards=shards, **REF)
    assert frame == ref.compress(data)
    assert eng.stats.as_dict() == ref.stats.as_dict()
    info = frame_info(frame)
    assert info["version"] == 4 and info["shard_count"] == shards
    counts = [0] * shards
    for b in info["blocks"]:
        counts[b["shard"]] += 1
    assert counts == [s.count for s in fabric.partition_blocks(n_blocks, shards)]
    assert decode_frame_serial(frame) == data
    assert LZ4DecodeEngine(device="cpu").decode(frame) == data


@pytest.mark.parametrize("kw", [dict(content_crc=True), dict(parity_group=4)])
def test_host_path_trailer_and_parity_equal_reference(kw):
    data = fabric_corpus(6, seed=11)
    frame = LZ4Engine(shards=2, **PORT, **kw).compress(data)
    assert frame == JaxEngine(shards=2, **REF, **kw).compress(data)
    assert frame_info(frame)["content_crc"] is not None
    assert LZ4DecodeEngine(device="cpu").decode(frame) == data


@pytest.mark.parametrize("seed", [0, 1])
def test_frame_identity_impl_x_shards_x_drain(seed):
    """(fused, sortkey) x shards (1, 2, 4) x drain (sliced, full), as the
    reference's seeded sweep: one frame per shard count, equal to the
    reference's, and the same payload bytes across shard counts."""
    data = fabric_corpus(4, seed=100 + seed)
    ref_payloads = None
    for shards in (1, 2, 4):
        want = JaxEngine(shards=shards, **REF).compress(data)
        for impl in ("fused", "sortkey"):
            for drain in ("sliced", "full"):
                got = LZ4Engine(shards=shards, candidate_impl=impl, drain=drain,
                                scan_impl="associative", device="cpu").compress(data)
                assert got == want, (impl, drain, shards)
        payloads = [want[b["offset"]: b["offset"] + b["csize"]]
                    for b in frame_info(want)["blocks"]]
        ref_payloads = ref_payloads or payloads
        assert payloads == ref_payloads, shards


def test_shard_subframe_equals_single_engine_and_reference():
    data = fabric_corpus(6, seed=42)
    frame = LZ4Engine(shards=3, **PORT).compress(data)
    jframe = JaxEngine(shards=3, **REF).compress(data)
    single = LZ4Engine(**PORT)
    for s, piece in enumerate(slices_of(data, 3)):
        sub = fabric.shard_subframe(frame, s)
        assert sub == single.compress(piece) == jfabric.shard_subframe(jframe, s)
    with pytest.raises(FrameFormatError, match="not a version-4"):
        fabric.shard_subframe(single.compress(data), 0)


def test_compress_to_blocks_sharded_equals_unsharded():
    data = fabric_corpus(5, seed=9)
    want = LZ4Engine(**PORT).compress_to_blocks(data)
    eng = LZ4Engine(shards=4, **PORT)
    assert eng.compress_to_blocks(data) == want
    ref = JaxEngine(shards=4, **REF)
    assert ref.compress_to_blocks(data) == want
    assert eng.stats.as_dict() == ref.stats.as_dict()
    assert LZ4Engine(mesh=cpu_mesh((2, 2)), **PORT).compress_to_blocks(data) == want


def test_each_package_decodes_the_others_v4_frames():
    data = fabric_corpus(5, seed=5)
    port = LZ4Engine(mesh=cpu_mesh((1, 4)), **PORT).compress(data)
    assert jax_decode_serial(port) == data
    assert JaxDecodeEngine().decode(port) == data
    ref = JaxEngine(shards=3, **REF).compress(data)
    assert LZ4DecodeEngine(device="cpu").decode(ref) == data
    assert LZ4DecodeEngine(mesh=cpu_mesh((3, 1))).decode(ref) == data


# -- mesh path --------------------------------------------------------------------

@pytest.mark.parametrize("shape", MESH_SHAPES)
def test_mesh_frame_equals_host_path_and_reference(shape, mesh_reference):
    S = shape[0] * shape[1]
    ref = mesh_reference[str(S)]
    data = fabric_corpus(7, seed=S)
    eng = LZ4Engine(mesh=cpu_mesh(shape), **PORT)
    assert eng.shards == S
    frame = eng.compress(data)
    assert frame == ref["frame"]
    assert frame == LZ4Engine(shards=S, **PORT).compress(data)
    assert eng.stats.as_dict() == ref["engine"]
    eng.compress_to_blocks(data)
    assert eng.stats.as_dict() == ref["to_blocks"]
    for s, piece in enumerate(slices_of(data, S)):
        if piece:
            assert fabric.shard_subframe(frame, s) == LZ4Engine(**PORT).compress(piece)


@pytest.mark.parametrize("planner", sorted(PLANNERS))
@pytest.mark.parametrize("shape", MESH_SHAPES)
def test_mesh_decode_equals_reference(shape, planner, mesh_reference):
    """Sharded decode under both planners: the data back, `DecodeStats`
    field by field, `decode_blocks`, `read_range` across every shard
    boundary, a corrupt payload's exact error, and the counted host
    fallback of payloads over a small `blk_cap`."""
    S = shape[0] * shape[1]
    ref = mesh_reference[str(S)]
    frame, data = ref["frame"], fabric_corpus(7, seed=S)
    mesh = cpu_mesh(shape)
    dec = LZ4DecodeEngine(mesh=mesh, micro_batch=2, **PLANNERS[planner])
    assert dec.decode(frame) == data
    assert dec.stats.as_dict() == ref["decode_" + planner]
    info = frame_info(frame)
    payloads = [frame[b["offset"]: b["offset"] + b["csize"]] for b in info["blocks"]]
    got = dec.decode_blocks(payloads, [b["raw"] for b in info["blocks"]],
                            [b["usize"] for b in info["blocks"]])
    assert b"".join(got) == data
    assert dec.stats.as_dict() == ref["blocks_" + planner]
    reader = FrameReader(frame, engine=dec, cache_blocks=0)
    bounds = {sl.start * MAX_BLOCK
              for sl in fabric.partition_blocks(len(info["blocks"]), S)}
    for b in sorted(x for x in bounds if 0 < x < len(data)):
        for start, length in ((b - 50, 100), (b - 1, 2),
                              (b - MAX_BLOCK // 2, MAX_BLOCK)):
            length = min(length, len(data) - start)
            assert reader.read_range(start, length) == data[start: start + length]
    for head in (False, True):
        bad, _ = corrupt_coded_block(frame, info, head)
        with pytest.raises(FrameFormatError) as err:
            dec.decode(bad)
        assert str(err.value) == ref[f"corrupt_{planner}_{head}"]
    small = LZ4DecodeEngine(mesh=mesh, micro_batch=2,
                            caps=DevicePlanCaps(blk_cap=SMALL_CAPS),
                            **PLANNERS[planner])
    assert small.decode(frame) == data
    assert small.stats.as_dict() == ref["small_" + planner]


def test_mesh_of_one_shard_takes_the_host_path_but_writes_v4():
    data = fabric_corpus(3, seed=3)
    mesh = cpu_mesh((1, 1))
    eng = LZ4Engine(mesh=mesh, **PORT)
    frame = eng.compress(data)
    assert frame_info(frame)["version"] == 4
    assert frame == JaxEngine(mesh=jax_single_mesh(), **REF).compress(data)
    dec = LZ4DecodeEngine(mesh=mesh)
    assert dec.decode(frame) == data and dec.stats.shards == 0


def test_unsharded_engine_keeps_the_v3_writer():
    data = fabric_corpus(2, seed=1)
    frame = LZ4Engine(**PORT).compress(data)
    assert frame_info(frame)["version"] == 3
    assert frame == JaxEngine(**REF).compress(data)


# -- configuration ----------------------------------------------------------------

def _message(fn) -> str:
    with pytest.raises(ValueError) as err:
        fn()
    return str(err.value)


@pytest.mark.parametrize("case", ["axes_no_mesh", "bad_shards", "unknown_axis",
                                  "count_mismatch", "host_emit"])
def test_config_refusals_match_reference(case):
    port_mesh, jax_mesh = cpu_mesh((1, 1)), jax_single_mesh()
    kw = {
        "axes_no_mesh": lambda m: dict(shard_axes=("data",)),
        "bad_shards": lambda m: dict(shards=0),
        "unknown_axis": lambda m: dict(mesh=m, shard_axes=("nope",)),
        "count_mismatch": lambda m: dict(mesh=m, shards=4),
        "host_emit": None,
    }[case]
    if case == "host_emit":
        # The reference needs two devices for this one; its message is
        # "the mesh fabric path requires device_emit=True (...)".
        with pytest.raises(ValueError, match="requires device_emit=True"):
            LZ4Engine(mesh=cpu_mesh((2, 1)), device_emit=False, **PORT)
        return
    got = _message(lambda: LZ4Engine(**PORT, **kw(port_mesh)))
    assert got == _message(lambda: JaxEngine(**REF, **kw(jax_mesh)))
    if case in ("axes_no_mesh", "unknown_axis"):
        got = _message(lambda: LZ4DecodeEngine(device="cpu", **kw(port_mesh)))
        assert got == _message(lambda: JaxDecodeEngine(**kw(jax_mesh)))


def test_jax_mesh_is_refused_with_a_type_error():
    jmesh = jax_single_mesh()
    for fn in (lambda: compat.engine_config(mesh=jmesh),
               lambda: compat.decode_engine_config(mesh=jmesh),
               lambda: LZ4Engine(mesh=jmesh, **PORT),
               lambda: LZ4DecodeEngine(mesh=jmesh, device="cpu")):
        with pytest.raises(TypeError, match="sharding.make_mesh"):
            fn()


def test_compat_passes_the_fabric_keywords_through():
    mesh = cpu_mesh((2, 2))
    kw = compat.engine_config(mesh=mesh, shard_axes=("data",), use_pallas=True)
    assert kw == dict(mesh=mesh, shard_axes=("data",))
    eng = LZ4Engine(**PORT, **kw)
    assert eng.shards == 2 and eng.shard_axes == ("data",)
    assert compat.engine_config(shards=3) == dict(shards=3)
    dec = LZ4DecodeEngine(device="cpu", **compat.decode_engine_config(
        mesh=mesh, use_pallas=False))
    assert dec.shards == 4
    data = fabric_corpus(3, seed=2)
    frame = eng.compress(data)
    assert frame == JaxEngine(shards=2, **REF).compress(data)
    assert dec.decode(frame) == data

