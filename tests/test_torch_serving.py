"""The port's serving slice against the JAX package's on the CPU: configs
field for field (full and reduced) with the registry, shapes and cells;
`make_batch` and `input_specs`; `ServingEngine` greedy outputs token for
token on seven architectures at ``.reduced()`` (the reference's weights
carried over); `launch.serve` on the CPU; `make_production_mesh`'s refusal;
a prefill cache offloaded by one package and restored by the other,
bit-exact; and that the slice imports neither `jax` nor `repro`.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.distributed.sharding import single_device_mesh, use_mesh
from repro.launch import inputs as jinputs
from repro.launch import mesh as jmesh
from repro.models import lm as jlm
from repro.serving import engine as jserve
from repro_torch import LZ4DecodeEngine, LZ4Engine
from repro_torch._tree import flatten
from repro_torch.configs import base
from repro_torch.launch import inputs
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve
from repro_torch.models import lm
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving import engine as tserve

import test_torch_util  # noqa: F401  (one torch thread per worker)

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
SERVED = ["qwen3-1.7b", "mixtral-8x7b", "gemma2-9b", "recurrentgemma-9b",
          "xlstm-125m", "whisper-small", "internvl2-26b"]


def as_dict(cfg) -> dict:
    d = dataclasses.asdict(cfg)
    d["segments"] = repr(d["segments"])   # LayerSpec/Segment of either package
    return d


@pytest.mark.parametrize("arch", base.all_arch_names())
def test_configs_equal_reference_field_for_field(arch):
    for full in (True, False):
        got, want = base.get_config(arch), jbase.get_config(arch)
        if not full:
            got, want = got.reduced(), want.reduced()
        assert as_dict(got) == as_dict(want)
        assert [dataclasses.astuple(s) for s in got.segments] == \
            [dataclasses.astuple(s) for s in want.segments]
        assert got.hd == want.hd
        assert type(got).__module__ == "repro_torch.configs.base"


def test_registry_shapes_and_cells_equal_reference():
    assert base.all_arch_names() == jbase.all_arch_names()
    assert base.LONG_CONTEXT_ARCHS == jbase.LONG_CONTEXT_ARCHS
    assert {k: dataclasses.astuple(v) for k, v in base.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in jbase.SHAPES.items()}
    for include in (False, True):
        assert base.cells(include) == jbase.cells(include)
    from repro_torch import configs
    assert configs.get_config is base.get_config
    with pytest.raises(AttributeError):
        configs.nothing_here  # noqa: B018


@pytest.mark.parametrize("arch", base.all_arch_names())
def test_make_batch_and_input_specs_equal_reference(arch):
    cfg, jcfg = base.get_config(arch).reduced(), jbase.get_config(arch).reduced()
    seq = 12 + (cfg.vision_tokens or 0)
    got, want = inputs.make_batch(5, cfg, 3, seq, device=CPU), jinputs.make_batch(5, jcfg, 3, seq)
    assert sorted(got) == sorted(want)
    for k in got:
        assert str(got[k].dtype).removeprefix("torch.") == str(want[k].dtype)
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    for name, shape in base.SHAPES.items():
        full, jfull = base.get_config(arch), jbase.get_config(arch)
        specs = inputs.input_specs(full, shape)
        jspecs = jinputs.input_specs(jfull, jbase.SHAPES[name])
        assert {k: (s, str(d).removeprefix("torch.")) for k, (s, d) in specs.items()} == \
            {k: (v.shape, str(v.dtype)) for k, v in jspecs.items()}
        assert inputs.batch_dims(full, shape) == jinputs.batch_dims(jfull, jbase.SHAPES[name])


def requests(cls, vocab, n=4, seed=3):
    rng = np.random.default_rng(seed)
    return [cls(uid=i, prompt=rng.integers(0, vocab, int(rng.integers(4, 24))).tolist(),
                max_new_tokens=int(rng.integers(3, 12))) for i in range(n)]


@pytest.mark.parametrize("arch", SERVED)
def test_serving_engine_outputs_equal_reference(arch):
    jcfg, cfg = jbase.get_config(arch).reduced(), base.get_config(arch).reduced()
    jparams = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), CPU)
    with use_mesh(single_device_mesh()):
        jeng = jserve.ServingEngine(jcfg, jparams, max_batch=4)
        for r in requests(jserve.Request, jcfg.vocab_size):
            jeng.add_request(r)
        want = jeng.run()
    eng = tserve.ServingEngine(cfg, params, max_batch=4, device="cpu")
    for r in requests(tserve.Request, cfg.vocab_size):
        eng.add_request(r)
    got = eng.run()
    assert [r.uid for r in got] == [r.uid for r in want]
    for g, w in zip(got, want):
        assert len(g.output) == g.max_new_tokens
        assert g.output == w.output, (arch, g.uid)
    assert not eng.queue


def test_serving_engine_refuses_params_on_another_device():
    cfg = base.get_config("qwen3-1.7b").reduced()
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), device=CPU)
    with pytest.raises(ValueError, match="params are on cpu"):
        tserve.ServingEngine(cfg, params, device="meta")


def test_launch_serve_runs_on_the_cpu(capsys):
    done = serve.main(["--requests", "4", "--device", "cpu", "--max-new-tokens", "5"])
    assert [len(r.output) for r in done] == [5] * 4
    out = capsys.readouterr().out
    assert out.startswith("[serve] 4 requests, 20 tokens in ")
    assert "req 0: prompt[" in out


@pytest.mark.parametrize("multi_pod", [False, True])
def test_make_production_mesh_refuses_as_reference(multi_pod, monkeypatch):
    """Both refuse fewer than 256 (512) devices.  Both packages are shown 8
    devices: a test worker's JAX may hold 512 forced host devices."""
    n = 512 if multi_pod else 256
    monkeypatch.setattr(jax, "devices", lambda *a: [jax.local_devices()[0]] * 8)
    with pytest.raises(RuntimeError, match=f"need {n} devices, found 8"):
        jmesh.make_production_mesh(multi_pod=multi_pod)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    with pytest.raises(RuntimeError, match=f"need {n} devices, found 8"):
        tmesh.make_production_mesh(multi_pod=multi_pod)


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
    a = np.asarray(x)
    return a.view(np.int16) if str(a.dtype) == "bfloat16" else a


@pytest.fixture(scope="module")
def prefill_caches():
    """The same prompt's prefill cache (qwen3, reduced, bfloat16 compute) in
    both packages: (port config, port params, port cache, reference cache)."""
    jcfg = dataclasses.replace(jbase.get_config("qwen3-1.7b").reduced(),
                               compute_dtype="bfloat16")
    cfg = dataclasses.replace(base.get_config("qwen3-1.7b").reduced(),
                              compute_dtype="bfloat16")
    jparams = jlm.init_params(jax.random.PRNGKey(1), jcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), CPU)
    with use_mesh(single_device_mesh()):
        jcache, _ = jax.jit(jlm.prefill, static_argnums=(2, 3))(
            jparams, jinputs.make_batch(2, jcfg, 2, 24), jcfg, 64)
    cache, _ = lm.prefill(params, inputs.make_batch(2, cfg, 2, 24, device=CPU), cfg, 64)
    return cfg, params, cache, jcache


def test_offloaded_caches_restore_bit_exact_across_packages(prefill_caches):
    _, _, cache, jcache = prefill_caches
    leaves = flatten(cache)[0]
    jleaves, jtreedef = jax.tree.flatten(jcache)
    assert [tuple(t.shape) for t in leaves] == [x.shape for x in jleaves]
    assert str(leaves[0].dtype) == "torch.bfloat16" and str(jleaves[0].dtype) == "bfloat16"
    # the port's blob, restored by the reference (its own tree definition)
    blob, stats = tserve.offload_cache(
        cache, engine=LZ4Engine(device="cpu", scan_impl="associative"))
    assert stats["raw"] == sum(t.numel() * t.element_size() for t in leaves)
    back = jserve.restore_cache([jtreedef, blob[1]])
    for a, b in zip(jax.tree.leaves(back), leaves):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    # the reference's blob, restored by the port, to the engine's device too
    jblob, _ = jserve.offload_cache(jcache)
    for to_device in (False, True):
        dec = LZ4DecodeEngine(device="cpu", plan_on_device=to_device)
        got = tserve.restore_cache([blob[0], jblob[1]], dec, to_device=to_device)
        assert got["enc_memory"] is None
        for a, b in zip(flatten(got)[0], jleaves):
            assert a.dtype == leaves[0].dtype or a.dtype == torch.int32
            np.testing.assert_array_equal(_bits(a), _bits(b))
        if to_device:
            assert dec.totals.host_bytes == 0


def test_restored_cache_continues_decoding_identically(prefill_caches):
    cfg, params, cache, _ = prefill_caches
    blob, _ = tserve.offload_cache(cache, engine=LZ4Engine(device="cpu",
                                                           scan_impl="associative"))
    restored = tserve.restore_cache(blob, LZ4DecodeEngine(device="cpu"))
    runs = []
    for c in (cache, restored):
        tok, steps = torch.tensor([5, 9], dtype=torch.int32), []
        for _ in range(3):
            logits, c = lm.decode_step(params, c, tok, c["pos"], cfg)
            tok = torch.argmax(logits, -1).to(torch.int32)
            steps.append(logits)
        runs.append(steps)
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_the_slice_imports_neither_jax_nor_repro():
    code = ("import sys\n"
            "import repro_torch.models, repro_torch.models.lm, repro_torch.serving\n"
            "import repro_torch.serving.engine, repro_torch.launch.serve\n"
            "import repro_torch.launch.mesh, repro_torch.configs.base\n"
            "from repro_torch.configs import get_config\n"
            "get_config('qwen3-1.7b')\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
            "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, env=env, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "[]"
