"""The port's mesh helpers and the fabric's consumers
(`repro_torch.distributed.{sharding,fault,pipeline}`,
`optim.grad_compress.compressed_psum_pod`, `checkpoint.restore(shardings=)`)
against the JAX package's, on the CPU.

The reference's multi-device results (the int8 pod-sum on a (2, 2)
``("pod", "data")`` mesh, the GPipe schedule on four pods) come from ONE
subprocess per module with ``XLA_FLAGS=--xla_force_host_platform_device_count=8``,
on seeded numpy inputs.  The port runs on meshes that repeat the CPU.
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
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.distributed import fault, sharding
from repro_torch.distributed.pipeline import bubble_fraction, pipeline_apply
from repro_torch.distributed.sharding import (
    Mesh,
    NamedSharding,
    P,
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

_REFERENCE = textwrap.dedent("""
    import json, sys
    import jax
    import jax.numpy as jnp
    import numpy as np
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
    print("RESULT:" + json.dumps(res))
""")


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _REFERENCE, json.dumps(PSUM_CASES)],
        capture_output=True, text=True, timeout=300, env=env, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [x for x in proc.stdout.splitlines() if x.startswith("RESULT:")][0]
    return {k: np.frombuffer(bytes.fromhex(v), np.float32)
            for k, v in json.loads(line[len("RESULT:"):]).items()}


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


def test_restore_refuses_a_leaf_across_distinct_devices(tmp_path):
    tree = _torch_tree(_tree())
    ckpt.save(str(tmp_path), 1, tree,
              engine=LZ4Engine(device="cpu", scan_impl="associative"))
    # Built directly: make_mesh would check that the card exists.
    two = Mesh(("data",), np.array([CPU, torch.device("cuda", 0)], dtype=object))
    sh = {"a": NamedSharding(two, P("data", None)), "w": None,
          "opt": {"i": [None, None]}, "step": None}
    dec = LZ4DecodeEngine(device="cpu")
    with pytest.raises(NotImplementedError, match="A9"):
        ckpt.restore(str(tmp_path), 1, tree, shardings=sh, decode_engine=dec)
    with pytest.raises(ValueError, match="do not match"):
        ckpt.restore(str(tmp_path), 1, tree, shardings={}, decode_engine=dec)
    bad_axis = dict(sh, a=NamedSharding(single_device_mesh("cpu"), P("pod")))
    with pytest.raises(ValueError, match="not in mesh"):
        ckpt.restore(str(tmp_path), 1, tree, shardings=bad_axis, decode_engine=dec)
    with pytest.raises(TypeError, match="NamedSharding"):
        ckpt.restore(str(tmp_path), 1, tree, shardings=dict(sh, a="data"),
                     decode_engine=dec)


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
