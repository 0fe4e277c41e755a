"""The port's mesh helpers and the fabric's consumers
(`repro_torch.distributed.{sharding,fault,pipeline}`,
`optim.grad_compress.compressed_psum_pod`, `checkpoint.restore(shardings=)`,
`sharding.device_put` / `ShardedTensor`) against the JAX package's, on the
CPU.

The reference's multi-device results (the int8 pod-sum on a (2, 2)
``("pod", "data")`` mesh, the GPipe schedule on four pods, the shards of
`jax.device_put` on meshes of 8 devices and of a 2-device
`restore(shardings=)`) come from ONE subprocess per module with
``XLA_FLAGS=--xla_force_host_platform_device_count=8``, on seeded numpy
inputs.  The port runs on meshes that repeat the CPU, and on ``[cpu, meta]``
where two distinct devices are needed.
"""
import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.distributed import fault as jfault
from repro.distributed import pipeline as jpipeline
from repro.distributed import sharding as jsh
from repro_torch import LZ4DecodeEngine, LZ4Engine
from repro_torch._tree import leaf_bytes
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.distributed import fault, sharding
from repro_torch.distributed.pipeline import bubble_fraction, pipeline_apply
from repro_torch.distributed.sharding import (
    NamedSharding,
    P,
    ShardedTensor,
    device_put,
    make_mesh,
    single_device_mesh,
    use_mesh,
)
from repro_torch.optim.grad_compress import compressed_psum_pod, pod_sum_codes
from repro_torch.resilience.retry import RestartPolicy

import test_torch_util  # noqa: F401  (one torch thread per test worker)

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
PSUM_CASES = {"pod_data": ((2, 2), ("pod", "data")), "pod": ((2,), ("pod",))}
S_STAGES, D, ROWS = 4, 16, 8
# jax.device_put cases: mesh shape, axes, array shape, dtype, spec (a list
# element is a tuple of axes).  They split, replicate and use tuple axes.
PUT_CASES = {
    "8_rows_f32": ((8,), ("data",), (16, 6), "float32", ("data", None)),
    "8_replicated_bf16": ((8,), ("data",), (16, 6), "bfloat16", ()),
    "8_cols_i32": ((8,), ("data",), (4, 24), "int32", (None, "data")),
    "2x4_both_f32": ((2, 4), ("data", "model"), (8, 12), "float32", ("data", "model")),
    "2x4_swapped_bf16": ((2, 4), ("data", "model"), (8, 12), "bfloat16", ("model", "data")),
    "2x4_tuple_i32": ((2, 4), ("data", "model"), (16, 3), "int32", (["data", "model"], None)),
    "2x4_tuple_reversed_f32": ((2, 4), ("data", "model"), (6, 8), "float32",
                               (None, ["model", "data"])),
    "2x4_short_spec_bf16": ((2, 4), ("data", "model"), (4, 6), "bfloat16", ("data",)),
    "2x2x2_each_bf16": ((2, 2, 2), ("pod", "data", "model"), (4, 4, 6), "bfloat16",
                        ("pod", "data", "model")),
    "2x2x2_tuple3_i32": ((2, 2, 2), ("pod", "data", "model"), (8, 5), "int32",
                         (["pod", "data", "model"], None)),
    "2x2x2_tuple_f32": ((2, 2, 2), ("pod", "data", "model"), (4, 6), "float32",
                        (["data", "pod"], "model")),
    "2x2x2_scalar_i32": ((2, 2, 2), ("pod", "data", "model"), (), "int32", ()),
}
# restore(shardings=) over two distinct devices: leaf path -> spec.
RESTORE_SPECS = {"/a": ("data", None), "/w": ("data",), "/opt/i/0": (None, "data"),
                 "/step": ()}

_REFERENCE = textwrap.dedent("""
    import json, sys
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec
    from repro.checkpoint import checkpoint as jckpt
    from repro.distributed.pipeline import pipeline_apply
    from repro.distributed.sharding import make_mesh_compat, use_mesh
    from repro.optim.grad_compress import compressed_psum_pod

    assert len(jax.devices()) == 8
    cases = json.loads(sys.argv[1])
    res = {}
    x = np.random.default_rng(7).normal(0, 1, (8, 16)).astype(np.float32)
    for name, (shape, axes) in cases.items():
        mesh = make_mesh_compat(tuple(shape), tuple(axes))
        with use_mesh(mesh):
            y = np.asarray(compressed_psum_pod(jnp.asarray(x)))
        res["psum_" + name] = y.astype(np.float32).tobytes().hex()
    rng = np.random.default_rng(0)
    S, d = 4, 16
    W = rng.normal(0, 0.5, (S, d, d)).astype(np.float32)
    b = rng.normal(0, 0.1, (S, d)).astype(np.float32)
    xs = rng.normal(0, 1, (8, d)).astype(np.float32)

    def stage_fn(p, h):
        return jnp.tanh(h @ p["w"] + p["b"])

    with use_mesh(make_mesh_compat((4,), ("pod",))):
        y = jax.jit(lambda pp, xx: pipeline_apply(stage_fn, pp, xx, n_micro=4))(
            {"w": jnp.asarray(W), "b": jnp.asarray(b)}, jnp.asarray(xs))
    res["pipeline"] = np.asarray(y, np.float32).tobytes().hex()

    def spec(parts):
        return PartitionSpec(*(tuple(p) if isinstance(p, list) else p for p in parts))

    def shards(a, mesh):
        flat = list(mesh.devices.flat)
        return sorted(
            ([flat.index(s.device), [[x.start, x.stop, x.step] for x in s.index],
              list(s.data.shape), np.asarray(s.data).tobytes().hex()]
             for s in a.addressable_shards), key=lambda r: r[0])

    puts = {}
    for name, c in json.loads(sys.argv[2]).items():
        x = np.frombuffer(bytes.fromhex(c["bits"]), np.dtype(c["bits_dtype"]))
        x = x.view(jnp.bfloat16 if c["dtype"] == "bfloat16" else c["dtype"])
        x = x.reshape(c["shape"])
        mesh = Mesh(np.array(jax.devices()[: int(np.prod(c["mesh"]))]).reshape(c["mesh"]),
                    tuple(c["axes"]))
        puts[name] = shards(jax.device_put(x, NamedSharding(mesh, spec(c["spec"]))), mesh)
    res["device_put"] = puts
    ckpt_dir, specs = sys.argv[3], json.loads(sys.argv[4])
    two = Mesh(np.array(jax.devices()[:2]), ("data",))
    like = {"a": np.zeros((64, 64), np.float32), "w": np.zeros((40000,), np.float32),
            "opt": {"i": [np.zeros((50, 40), np.int32), None]}, "step": np.int32(0)}
    sh = {"a": NamedSharding(two, spec(specs["/a"])),
          "w": NamedSharding(two, spec(specs["/w"])),
          "opt": {"i": [NamedSharding(two, spec(specs["/opt/i/0"])), None]},
          "step": NamedSharding(two, spec(specs["/step"]))}
    tree, _ = jckpt.restore(ckpt_dir, 1, like, shardings=sh)
    res["restore_distinct"] = {
        "/a": shards(tree["a"], two), "/w": shards(tree["w"], two),
        "/opt/i/0": shards(tree["opt"]["i"][0], two), "/step": shards(tree["step"], two)}
    print("RESULT:" + json.dumps(res))
""")


def _put_array(name: str) -> np.ndarray:
    """Seeded numpy bits of case ``name``: bfloat16 as uint16 (float32
    normals cut to their top half), float32 and int32 as themselves."""
    _, _, shape, dtype, _ = PUT_CASES[name]
    rng = np.random.default_rng(sorted(PUT_CASES).index(name))
    if dtype == "bfloat16":
        f = rng.normal(0, 1, shape).astype(np.float32)
        return (np.asarray(f).view(np.uint32) >> 16).astype(np.uint16)
    if dtype == "int32":
        return rng.integers(-1000, 1000, shape).astype(np.int32)
    return rng.normal(0, 1, shape).astype(np.float32)


def _put_tensor(name: str) -> torch.Tensor:
    bits = _put_array(name)
    if PUT_CASES[name][3] == "bfloat16":
        return torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(bits.copy())


def _spec(parts) -> P:
    return P(*(tuple(p) if isinstance(p, list) else p for p in parts))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's results; its 2-device restore reads a checkpoint that
    the port saved (`_tree()`, step 1), passed back as ``"ckpt_dir"``."""
    ckpt_dir = tmp_path_factory.mktemp("distinct_ckpt")
    ckpt.save(str(ckpt_dir), 1, _torch_tree(_tree()),
              engine=LZ4Engine(device="cpu", scan_impl="associative"))
    puts = {}
    for name, (mesh, axes, shape, dtype, spec) in PUT_CASES.items():
        bits = _put_array(name)
        puts[name] = dict(mesh=mesh, axes=axes, shape=shape, dtype=dtype, spec=spec,
                          bits=bits.tobytes().hex(), bits_dtype=str(bits.dtype))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _REFERENCE, json.dumps(PSUM_CASES), json.dumps(puts),
         str(ckpt_dir), json.dumps(RESTORE_SPECS)],
        capture_output=True, text=True, timeout=300, env=env, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [x for x in proc.stdout.splitlines() if x.startswith("RESULT:")][0]
    res = json.loads(line[len("RESULT:"):])
    out = {k: np.frombuffer(bytes.fromhex(v), np.float32)
           for k, v in res.items() if k.startswith("psum_") or k == "pipeline"}
    out.update(device_put=res["device_put"], restore_distinct=res["restore_distinct"],
               ckpt_dir=str(ckpt_dir))
    return out


def cpu_mesh(shape, axes):
    return make_mesh(shape, axes, devices=[CPU] * int(np.prod(shape)))


# -- mesh helpers ----------------------------------------------------------------

def test_mesh_shape_size_and_positions():
    mesh = cpu_mesh((2, 4), ("data", "model"))
    assert list(mesh.shape.items()) == [("data", 2), ("model", 4)]
    assert mesh.size == 8 and mesh.axis_names == ("data", "model")
    assert mesh.device_at((1, 3)) == CPU
    grid = make_mesh((1, 2), ("data", "model"),
                     devices=[torch.device("cpu"), "cpu"])
    assert grid.devices.shape == (1, 2) and grid.devices.dtype == object
    with pytest.raises(ValueError, match="needs 4 devices"):
        make_mesh((2, 2), ("data", "model"), devices=[CPU] * 3)
    with pytest.raises(ValueError, match="differ in length"):
        make_mesh((2, 2), ("data",), devices=[CPU] * 4)
    with pytest.raises(ValueError, match="repeated axis"):
        make_mesh((1, 1), ("data", "data"), devices=[CPU])
    with pytest.raises(ValueError, match="CUDA devices, the CPU or meta"):
        make_mesh((1,), ("data",), devices=["mps"])
    meta = make_mesh((2, 2), ("data", "model"), devices=["meta"] * 4)
    assert meta.device_at((1, 1)) == torch.device("meta")


def test_mesh_devices_default_to_the_cards():
    if torch.cuda.is_available():
        pytest.skip("this case is about a machine without CUDA devices")
    with pytest.raises(RuntimeError, match="needs 2 CUDA devices, 0 visible"):
        make_mesh((2, 1), ("data", "model"))
    with pytest.raises(RuntimeError, match="cuda"):
        make_mesh((1,), ("data",), devices=["cuda"])
    with pytest.raises(RuntimeError):
        single_device_mesh()
    mesh = single_device_mesh("cpu")
    assert mesh.shape == {"data": 1, "model": 1}
    assert mesh.shape == dict(jsh.single_device_mesh().shape)


def test_global_mesh_context_and_batch_axes_match_reference():
    m = cpu_mesh((2, 2, 2), ("pod", "data", "model"))
    assert sharding.get_mesh() is None
    assert sharding.batch_axes() == jsh.batch_axes() == ()
    assert sharding.local_batch(64) == jsh.local_batch(64) == 64
    with use_mesh(m) as got:
        assert got is m and sharding.get_mesh() is m
        assert sharding.batch_axes() == ("pod", "data")
        assert sharding.batch_axes(pure_dp=True) == ("pod", "data", "model")
        assert sharding.local_batch(64) == 16
        with pytest.raises(ValueError, match="does not divide"):
            sharding.local_batch(6)
    assert sharding.get_mesh() is None
    sharding.set_global_mesh(m)
    try:
        assert sharding.get_mesh() is m
    finally:
        sharding.set_global_mesh(None)
    one = single_device_mesh("cpu")
    jone = jsh.single_device_mesh()
    for pure in (False, True):
        assert sharding.batch_axes(one, pure) == jsh.batch_axes(jone, pure)
    assert sharding.local_batch(8, one) == jsh.local_batch(8, jone)


def test_partition_spec_and_named_sharding():
    spec = P("data", None)
    assert spec == ("data", None) and isinstance(spec, tuple)
    assert tuple(spec) == tuple(jax.sharding.PartitionSpec("data", None))
    assert P() == () and repr(P(None)) == "P(None,)"
    mesh = single_device_mesh("cpu")
    ns = sharding.sharding(spec, mesh)
    assert isinstance(ns, NamedSharding) and ns.mesh is mesh and ns.spec == spec
    with use_mesh(mesh):
        assert sharding.sharding(P()).mesh is mesh


# -- device_put / ShardedTensor -------------------------------------------------------

@pytest.mark.parametrize("name", sorted(PUT_CASES))
def test_sharded_tensor_equals_reference_device_put(name, reference):
    """On a mesh that repeats the CPU, `shard_indices` and
    `ShardedTensor.from_tensor` equal the reference's `addressable_shards`
    position by position: index, shape and bytes (tolerance 0).  Every shard
    is a contiguous copy of its own; `full` gives the tensor back bit for
    bit; `device_put` onto one distinct device is a plain tensor."""
    mesh_shape, axes, shape, _, spec = PUT_CASES[name]
    x = _put_tensor(name)
    ns = NamedSharding(cpu_mesh(mesh_shape, axes), _spec(spec))
    t = ShardedTensor.from_tensor(x, ns)
    assert t.shape == shape and t.dtype == x.dtype and t.sharding is ns
    assert [s.index for s in t.shards] == ns.shard_indices(shape)
    assert _shards_of(t) == reference["device_put"][name]
    for s in t.shards:
        assert s.device == s.data.device == CPU and s.data.is_contiguous()
        assert s.data.untyped_storage().data_ptr() != x.untyped_storage().data_ptr()
    assert len({s.data.untyped_storage().data_ptr() for s in t.shards}) == len(t.shards)
    whole = t.full(CPU)
    assert whole.dtype == x.dtype and whole.shape == x.shape
    assert leaf_bytes(whole)[0].tobytes() == leaf_bytes(x)[0].tobytes()
    placed = device_put(x, ns)
    assert isinstance(placed, torch.Tensor) and placed.device == CPU
    assert torch.equal(placed, x)


def test_device_put_refuses_what_the_reference_refuses():
    mesh = cpu_mesh((2, 4), ("data", "model"))
    x = torch.zeros((6, 8))
    for spec in (P("model", None), P(("data", "model"), None)):
        with pytest.raises(ValueError, match="does not divide"):
            device_put(x, NamedSharding(mesh, spec))
        with pytest.raises(ValueError, match="does not divide"):
            NamedSharding(mesh, spec).shard_indices(x.shape)
    with pytest.raises(ValueError, match="not in mesh"):
        device_put(x, NamedSharding(mesh, P("pod")))
    with pytest.raises(TypeError, match="NamedSharding"):
        device_put(x, P("data"))
    with pytest.raises(ValueError, match="more dimensions"):
        device_put(torch.zeros(4), NamedSharding(mesh, P("data", None)))


def test_sharded_tensor_full_refuses_a_meta_shard():
    """A shard on ``meta`` has a shape and no data: `full` raises rather
    than fill its part with anything, even where a CPU shard holds a
    replicated copy."""
    two = make_mesh((2,), ("data",), devices=["cpu", "meta"])
    x = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    for spec in (P("data", None), P()):
        t = device_put(x, NamedSharding(two, spec))
        assert isinstance(t, ShardedTensor)
        assert t.shards[1].data.device.type == "meta"
        assert tuple(t.shards[1].data.shape) == NamedSharding(two, spec).shard_shape(x.shape)
        assert torch.equal(t.shards[0].data, x[t.shards[0].index])
        with pytest.raises(RuntimeError, match="meta"):
            t.full(CPU)


# -- int8 pod-sum -----------------------------------------------------------------

def _psum_input() -> torch.Tensor:
    return torch.from_numpy(
        np.random.default_rng(7).normal(0, 1, (8, 16)).astype(np.float32))


@pytest.mark.parametrize("case", sorted(PSUM_CASES))
def test_compressed_psum_pod_equals_reference(case, reference):
    """The codes are the reference's exactly; the sum within 1 ulp."""
    shape, axes = PSUM_CASES[case]
    x = _psum_input()
    mesh = cpu_mesh(shape, axes)
    with use_mesh(mesh):
        y = compressed_psum_pod(x).numpy()
    totals, scales = pod_sum_codes(x, mesh)
    want = reference["psum_" + case].reshape(y.shape)
    ways = len(totals)
    for c, (t, s) in enumerate(zip(totals, scales)):
        rows = slice(c * 8 // ways, (c + 1) * 8 // ways)
        ref_codes = np.rint(want[rows].astype(np.float64) / float(s))
        np.testing.assert_array_equal(t.numpy(), ref_codes.astype(np.int32))
        assert np.abs(t.numpy()).max() <= 127 * mesh.shape["pod"]
    assert np.all(np.abs(y - want) <= np.spacing(np.abs(want)))
    # The pod-sum of replicated input is pods x the input, to int8 precision.
    pods = mesh.shape["pod"]
    assert np.abs(y - pods * x.numpy()).max() <= pods * max(float(s) for s in scales)


def test_compressed_psum_pod_without_a_pod_axis_returns_the_input():
    x = _psum_input()
    assert compressed_psum_pod(x) is x
    with use_mesh(cpu_mesh((2, 2), ("data", "model"))):
        assert compressed_psum_pod(x) is x
    with use_mesh(cpu_mesh((2, 3), ("pod", "data"))):
        with pytest.raises(ValueError, match="does not split"):
            compressed_psum_pod(x)


# -- restore(shardings=) ------------------------------------------------------------

def _tree(seed: int = 3) -> dict:
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(0, 1, (64, 64)).astype(np.float32),
            "w": np.zeros((40_000,), np.float32),
            "opt": {"i": [rng.integers(-900, 900, (50, 40)).astype(np.int32), None]},
            "step": np.int32(9)}


def _torch_tree(t: dict) -> dict:
    return {"a": torch.from_numpy(t["a"].copy()), "w": torch.from_numpy(t["w"].copy()),
            "opt": {"i": [torch.from_numpy(t["opt"]["i"][0].copy()), None]},
            "step": torch.tensor(int(t["step"]), dtype=torch.int32)}


def test_restore_with_shardings_equals_reference(tmp_path):
    """Shardings over a single-device mesh, every spec all-None (the
    reference's own elastic-restore case), against the reference's
    `restore(shardings=)` of the same checkpoint."""
    tree = _tree()
    ckpt.save(str(tmp_path), 2, _torch_tree(tree),
              engine=LZ4Engine(device="cpu", scan_impl="associative"))
    mesh = single_device_mesh("cpu")
    like = {k: (torch.empty(v.shape, dtype=torch.float32, device="meta")
                if k in ("a", "w") else v)
            for k, v in _torch_tree(tree).items()}
    sh = {"a": NamedSharding(mesh, P(None, None)), "w": NamedSharding(mesh, P(None)),
          "opt": {"i": [NamedSharding(mesh, P("data", "model")), None]},
          "step": None}
    got, step = ckpt.restore(str(tmp_path), 2, like, shardings=sh,
                             decode_engine=LZ4DecodeEngine(device="cpu"))
    jtree = jax.tree.map(jax.numpy.asarray, tree)
    jmesh = jsh.single_device_mesh()
    jsh_tree = jax.tree.map(
        lambda x: jax.sharding.NamedSharding(jmesh, jax.sharding.PartitionSpec(
            *((None,) * x.ndim))), jtree)
    want, jstep = jckpt.restore(str(tmp_path), 2, jtree, shardings=jsh_tree)
    assert step == jstep == 2
    for g, w in zip(jax.tree.leaves(want), [got["a"], got["opt"]["i"][0],
                                           got["step"], got["w"]]):
        assert g.shape == tuple(w.shape)
        np.testing.assert_array_equal(np.asarray(g), w.numpy())
        assert w.device == CPU
    assert got["opt"]["i"][1] is None
    # None shardings keep the `like` placement, and the whole tree may be None.
    plain, _ = ckpt.restore(str(tmp_path), 2, _torch_tree(tree),
                            decode_engine=LZ4DecodeEngine(device="cpu"))
    for k in ("a", "w", "step"):
        assert torch.equal(plain[k], got[k])


def _index(index) -> list:
    return [[x.start, x.stop, x.step] for x in index]


def _shards_of(t: ShardedTensor) -> list:
    """``t``'s shards as the reference subprocess writes them (position,
    index, shape, data hex; no data on ``meta``)."""
    return [[k, _index(s.index), list(s.data.shape),
             None if s.device.type == "meta" else leaf_bytes(s.data)[0].tobytes().hex()]
            for k, s in enumerate(t.shards)]


def test_restore_refuses_a_leaf_across_distinct_devices(reference):
    """Over a mesh of two distinct devices ([cpu, meta]) `restore(shardings=)`
    no longer refuses: each leaf comes back as a `ShardedTensor` whose CPU
    shards equal the reference's pieces of the same checkpoint (index and
    bytes) and whose meta shard has the reference's index and shape;
    `restore_with_fallback` passes ``shardings`` through unchanged.  The
    refusals that stay: a tree that does not match, an axis missing from the
    mesh, a sharding that is not a `NamedSharding`."""
    tree = _torch_tree(_tree())
    two = make_mesh((2,), ("data",), devices=["cpu", "meta"])
    sh = {"a": NamedSharding(two, _spec(RESTORE_SPECS["/a"])),
          "w": NamedSharding(two, _spec(RESTORE_SPECS["/w"])),
          "opt": {"i": [NamedSharding(two, _spec(RESTORE_SPECS["/opt/i/0"])), None]},
          "step": NamedSharding(two, _spec(RESTORE_SPECS["/step"]))}
    dec = LZ4DecodeEngine(device="cpu")
    got, step = ckpt.restore(reference["ckpt_dir"], 1, tree, shardings=sh, decode_engine=dec)
    back, bstep = ckpt.restore_with_fallback(reference["ckpt_dir"], tree, shardings=sh,
                                             decode_engine=dec)
    assert step == bstep == 1 and got["opt"]["i"][1] is None
    want = reference["restore_distinct"]
    for path, leaf, again, orig in (("/a", got["a"], back["a"], tree["a"]),
                                    ("/w", got["w"], back["w"], tree["w"]),
                                    ("/opt/i/0", got["opt"]["i"][0], back["opt"]["i"][0],
                                     tree["opt"]["i"][0]),
                                    ("/step", got["step"], back["step"], tree["step"])):
        assert isinstance(leaf, ShardedTensor) and isinstance(again, ShardedTensor)
        assert leaf.shape == tuple(orig.shape) and leaf.dtype == orig.dtype
        assert [s.device for s in leaf.shards] == [CPU, torch.device("meta")]
        assert all(s.data.device == s.device for s in leaf.shards)
        mine = _shards_of(leaf)
        assert _shards_of(again) == mine
        assert [r[:3] for r in mine] == [r[:3] for r in want[path]], path
        assert mine[0][3] == want[path][0][3], path
    with pytest.raises(ValueError, match="do not match"):
        ckpt.restore(reference["ckpt_dir"], 1, tree, shardings={}, decode_engine=dec)
    bad_axis = dict(sh, a=NamedSharding(single_device_mesh("cpu"), P("pod")))
    with pytest.raises(ValueError, match="not in mesh"):
        ckpt.restore(reference["ckpt_dir"], 1, tree, shardings=bad_axis, decode_engine=dec)
    with pytest.raises(TypeError, match="NamedSharding"):
        ckpt.restore(reference["ckpt_dir"], 1, tree, shardings=dict(sh, a="data"),
                     decode_engine=dec)


def test_restore_refuses_a_dimension_that_does_not_divide(tmp_path):
    """(64, 64) over three positions: ValueError, as the reference's
    `jax.device_put` raises; `restore_with_fallback` counts it as a step
    that does not restore."""
    ckpt.save(str(tmp_path), 1, _torch_tree(_tree()),
              engine=LZ4Engine(device="cpu", scan_impl="associative"))
    three = make_mesh((3,), ("data",), devices=["cpu", "meta", "cpu"])
    sh = {"a": NamedSharding(three, P("data", None)), "w": None,
          "opt": {"i": [None, None]}, "step": None}
    dec = LZ4DecodeEngine(device="cpu")
    like = _torch_tree(_tree())
    with pytest.raises(ValueError, match="does not divide over 3 devices"):
        ckpt.restore(str(tmp_path), 1, like, shardings=sh, decode_engine=dec)
    with pytest.raises(ckpt.CheckpointError, match="does not divide"):
        ckpt.restore_with_fallback(str(tmp_path), like, shardings=sh, decode_engine=dec)


# -- fault -------------------------------------------------------------------------

STEP_TIMES = [1.0, 1.1, 0.9, 1.0, 1.2, 1.0, 5.0, 1.0, 0.8, 4.5, 1.1, 6.0, 1.0, 9.0]


def _scripted(monkeypatch, monitor) -> list:
    clock = [0.0]
    monkeypatch.setattr(time, "perf_counter", lambda: clock[0])
    out = []
    for dt in STEP_TIMES:
        monitor.start()
        clock[0] += dt
        out.append(monitor.stop())
        out.append(monitor.should_remesh())
    return out


def test_step_monitor_equals_reference(monkeypatch):
    got = _scripted(monkeypatch, fault.StepMonitor())
    want = _scripted(monkeypatch, jfault.StepMonitor())
    assert got == want
    assert any(r["straggler"] for r in got if isinstance(r, dict))
    for kw in (dict(warmup_steps=0, straggler_factor=2.0), dict(ema_alpha=0.5)):
        a = _scripted(monkeypatch, fault.StepMonitor(**kw))
        assert a == _scripted(monkeypatch, jfault.StepMonitor(**kw))


def test_restart_policy_and_simulated_failure():
    assert fault.RestartPolicy is RestartPolicy
    p, q = fault.RestartPolicy(max_failures=2), jfault.RestartPolicy(max_failures=2)
    assert [p.record_failure() for _ in range(2)] == [q.record_failure() for _ in range(2)]
    with pytest.raises(RuntimeError, match="giving up"):
        p.record_failure()
    assert issubclass(fault.SimulatedFailure, RuntimeError)


# -- pipeline ----------------------------------------------------------------------

def test_bubble_fraction_equals_reference():
    for s, t in ((2, 2), (4, 16), (1, 8), (4, 4), (8, 3)):
        assert bubble_fraction(s, t) == jpipeline.bubble_fraction(s, t)


def test_pipeline_apply_equals_sequential_and_reference(reference):
    rng = np.random.default_rng(0)
    W = rng.normal(0, 0.5, (S_STAGES, D, D)).astype(np.float32)
    b = rng.normal(0, 0.1, (S_STAGES, D)).astype(np.float32)
    x = torch.from_numpy(rng.normal(0, 1, (ROWS, D)).astype(np.float32))
    params = {"w": torch.from_numpy(W), "b": torch.from_numpy(b)}

    def stage_fn(p, h):
        return torch.tanh(h @ p["w"] + p["b"])

    with use_mesh(cpu_mesh((S_STAGES,), ("pod",))):
        y = pipeline_apply(stage_fn, params, x, n_micro=4)
        y2 = pipeline_apply(stage_fn, params, x, n_micro=2)
        with pytest.raises(ValueError, match="microbatches"):
            pipeline_apply(stage_fn, params, x, n_micro=3)
    seq = x
    for s in range(S_STAGES):
        seq = stage_fn({"w": params["w"][s], "b": params["b"][s]}, seq)
    assert y.shape == x.shape and y.device == x.device
    assert (y - seq).abs().max().item() < 1e-6
    assert (y2 - seq).abs().max().item() < 1e-6
    want = reference["pipeline"].reshape(ROWS, D)
    assert np.abs(y.numpy() - want).max() < 1e-6
    with pytest.raises(RuntimeError, match="current mesh"):
        pipeline_apply(stage_fn, params, x)
