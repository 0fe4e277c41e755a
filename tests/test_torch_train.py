"""Training in the port (`repro_torch.models.lm.train_loss`, `optim.adamw`,
`launch.steps`, `launch.roofline`) against the JAX package on the CPU.

`train_loss` and its gradient for all ten architectures at ``.reduced()``
(B = 2, S = 32) on the reference's weights (carried over by
`params_from_numpy`) against the jitted `jax.value_and_grad` of
`repro.models.lm.train_loss`: loss within 1e-4, each gradient leaf within
1e-4 x max(1, max|g_ref|).  Remat (full, "dots" and off) agree within 1e-6.
`adamw.lr_at` for the three schedules within 1e-7; `adamw.update` over five
steps with clipping active and inactive within 1e-6; one `make_train_step`
step with and without a gradient compressor.  The spec trees
(`batch_specs`, `cache_specs`, `sanitize_spec`) and `optimized_config` /
`serving_config` at full shapes on (2, 2) and (2, 2, 2) meshes; the model
counts of `roofline` exactly.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SHAPES, all_arch_names, get_config as jax_get_config
from repro.distributed import sharding as jshard
from repro.launch import roofline as jroof
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.optim import grad_compress as jgrad
from repro_torch._tree import flatten, flatten_with_paths, unflatten
from repro_torch.configs.base import get_config
from repro_torch.distributed import sharding as tshard
from repro_torch.launch import roofline, steps
from repro_torch.models import lm
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import adamw
from repro_torch.optim import grad_compress as tgrad

from test_torch_lm import as_np, jax_paths, np_tree, setup, torch_paths

ARCHS = all_arch_names()
TOL = 1e-4
CPU = torch.device("cpu")


def reference_value_and_grad(jparams, jbatch, jcfg):
    with jshard.use_mesh(jshard.single_device_mesh()):
        return jax.jit(jax.value_and_grad(jlm.train_loss), static_argnums=2)(
            jparams, jbatch, jcfg)


def assert_grads_close(got, want, tol, what):
    g, w = torch_paths(got), jax_paths(want)
    assert list(g) == list(w), what
    for path in g:
        ref = np.asarray(w[path], np.float32)
        np.testing.assert_allclose(as_np(g[path]), ref, rtol=0,
                                   atol=tol * max(1.0, float(np.abs(ref).max())),
                                   err_msg=f"{what} {path}")


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grad_equal_reference(arch):
    jcfg, cfg, jparams, params, jbatch, batch = setup(arch)
    want_loss, want_grads = reference_value_and_grad(jparams, jbatch, jcfg)
    loss, grads = steps.loss_and_grads(params, batch, cfg)
    assert loss.dtype == torch.float32 and loss.shape == ()
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=0, atol=TOL)
    assert_grads_close(grads, want_grads, TOL, f"{arch} grads")
    # the parameters given are left as they were (no grad, no .grad)
    assert all(not p.requires_grad and p.grad is None for p in flatten(params)[0])
    # train_loss itself is differentiable: autograd reaches the embedding
    leaf = params["embed"].detach().requires_grad_(True)
    lm.train_loss(dict(params, embed=leaf), batch, cfg).backward()
    np.testing.assert_allclose(as_np(leaf.grad), np.asarray(want_grads["embed"]),
                               rtol=0, atol=TOL * max(1.0, float(np.abs(want_grads["embed"]).max())))


def saved_bytes(fn) -> int:
    """Bytes autograd keeps for the backward pass of ``fn()`` outside any
    checkpointed region."""
    total = [0]

    def pack(t):
        total[0] += t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return total[0]


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mixtral-8x7b", "recurrentgemma-9b"])
def test_remat_modes_agree(arch):
    """Remat changes what is kept for the backward pass, never a value."""
    _, cfg, _, params, _, batch = setup(arch)
    assert cfg.remat and cfg.remat_policy == "full"
    modes = {"full": cfg, "dots": dataclasses.replace(cfg, remat_policy="dots"),
             "off": dataclasses.replace(cfg, remat=False)}
    out = {name: steps.loss_and_grads(params, batch, c) for name, c in modes.items()}
    for name in ("dots", "off"):
        np.testing.assert_allclose(float(out[name][0]), float(out["full"][0]),
                                   rtol=0, atol=1e-6)
        for a, b in zip(flatten(out[name][1])[0], flatten(out["full"][1])[0]):
            np.testing.assert_allclose(as_np(a), as_np(b), rtol=0, atol=1e-6,
                                       err_msg=f"{arch} remat {name}")

    def loss_of(c):
        leaves, treedef = flatten(params)
        live = [p.detach().requires_grad_(True) for p in leaves]
        return lambda: lm.train_loss(unflatten(treedef, live), batch, c)

    assert saved_bytes(loss_of(modes["full"])) < saved_bytes(loss_of(modes["off"]))
    # forward_logits / prefill stay out of autograd with remat on
    assert not lm.forward_logits(params, batch, cfg).requires_grad


@pytest.mark.parametrize("schedule", ["cosine", "wsd", "constant"])
def test_lr_at_equals_reference(schedule):
    kw = dict(lr=3e-4, warmup_steps=10, total_steps=100, schedule=schedule)
    jcfg, cfg = jadamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    for step in (0, 1, 5, 10, 50, 89, 90, 95, 100, 150):
        want = float(jadamw.lr_at(jcfg, step))
        got = adamw.lr_at(cfg, step)
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), want, rtol=0, atol=1e-7,
                                   err_msg=f"{schedule} step {step}")
        got_t = adamw.lr_at(cfg, torch.tensor(step, dtype=torch.int32))
        assert float(got_t) == float(got)
    with pytest.raises(ValueError):
        adamw.lr_at(dataclasses.replace(cfg, schedule="linear"), 3)


def _param_tree(rng):
    return {"w": rng.normal(0, 0.5, (6, 5)).astype(np.float32),
            "blocks": [{"b": rng.normal(0, 1, (7,)).astype(np.float32)},
                       {"b": rng.normal(0, 1, (3, 4)).astype(np.float32)}],
            "half": rng.normal(0, 1, (8, 3)).astype(jnp.bfloat16)}


@pytest.mark.parametrize("clip", [0.05, 1e6], ids=["clipping", "no_clipping"])
def test_adamw_update_equals_reference(clip):
    rng = np.random.default_rng(7)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=6, grad_clip=clip)
    jcfg, cfg = jadamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    jparams = jax.tree.map(jnp.asarray, _param_tree(rng))
    params = params_from_numpy(np_tree(jparams), CPU)
    jstate, state = jadamw.init(jparams), adamw.init(params)
    assert state["step"].dtype == torch.int32 and state["step"].shape == ()
    jupd = jax.jit(jadamw.update, static_argnums=3)
    for i in range(5):
        g = jax.tree.map(lambda p: rng.normal(0, 2, p.shape).astype(p.dtype), np_tree(jparams))
        jparams, jstate, jm = jupd(jax.tree.map(jnp.asarray, g), jstate, jparams, jcfg)
        before = [t.clone() for t in flatten(params)[0]]
        with torch.no_grad():
            new, state, m = adamw.update(params_from_numpy(g, CPU), state, params, cfg)
        assert all(torch.equal(a, b) for a, b in zip(flatten(params)[0], before))
        params = new
        for tree, want in ((params, jparams), (state, jstate)):
            got_leaves = dict(flatten_with_paths(tree))
            for path, w in jax_paths(want).items():
                got = got_leaves[path]
                assert str(got.dtype).removeprefix("torch.") == str(w.dtype), path
                np.testing.assert_allclose(as_np(got), np.asarray(w, np.float32),
                                           rtol=0, atol=1e-6, err_msg=f"step {i} {path}")
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-6, atol=0)
        clipped = float(m["grad_norm"]) > clip
        assert clipped == (clip < 1)


@pytest.mark.parametrize("compress", [False, True])
def test_train_step_equals_reference(compress):
    jcfg, cfg, jparams, params, jbatch, batch = setup("qwen3-1.7b")
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    jcomp = (lambda g: jgrad.quantize_with_error_feedback(g, jgrad.ef_init(g))[0]) \
        if compress else None
    comp = (lambda g: tgrad.quantize_with_error_feedback(g, tgrad.ef_init(g))[0]) \
        if compress else None
    jstep = jsteps.make_train_step(jcfg, jadamw.AdamWConfig(**kw), jcomp)
    step = steps.make_train_step(cfg, adamw.AdamWConfig(**kw), comp)
    with jshard.use_mesh(jshard.single_device_mesh()):
        jp, js, jm = jax.jit(jstep)(jparams, jadamw.init(jparams), jbatch)
    p, s, m = step(params, adamw.init(params), batch)
    assert not any(t.requires_grad for t in flatten((p, s, m))[0])
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=TOL, atol=0, err_msg=k)
    for tree, want, tol in ((p, jp, 1e-5), (s["m"], js["m"], 1e-6), (s["v"], js["v"], 1e-7)):
        got_leaves = dict(flatten_with_paths(tree))
        for path, w in jax_paths(want).items():
            np.testing.assert_allclose(as_np(got_leaves[path]), np.asarray(w), rtol=0,
                                       atol=tol, err_msg=path)
    assert int(s["step"]) == int(js["step"]) == 1


class _FakeMesh:
    """What the reference's spec functions read of a mesh: axis names, sizes
    and device count."""

    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)
        self.size = int(np.prod(list(shape.values())))


MESHES = {"2x2": {"data": 2, "model": 2}, "2x2x2": {"pod": 2, "data": 2, "model": 2}}


def _meshes(name):
    shape = MESHES[name]
    return _FakeMesh(shape), tshard.make_mesh(tuple(shape.values()), tuple(shape),
                                              devices=[CPU] * int(np.prod(list(shape.values()))))


def _spec_paths(tree, is_spec):
    """path -> spec tuple, over a tree whose leaves are specs (or None)."""
    out = {}

    def walk(t, path):
        if is_spec(t):
            out[path] = tuple(t)
        elif isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], f"{path}/{k}")
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, f"{path}/{i}")
        else:
            assert t is None, (path, t)

    walk(tree, "")
    return out


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_reference(arch, mesh_name):
    jmesh, mesh = _meshes(mesh_name)
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    for pure_dp in (False, True):
        jb = jsteps.batch_specs(dataclasses.replace(jcfg, pure_dp=pure_dp), jmesh)
        tb = steps.batch_specs(dataclasses.replace(cfg, pure_dp=pure_dp), mesh)
        assert {k: tuple(v) for k, v in tb.items()} == {k: tuple(v) for k, v in jb.items()}
        assert all(isinstance(v, tshard.PartitionSpec) for v in tb.values())
    with tshard.use_mesh(mesh):   # the port's default mesh is the current one
        assert steps.batch_specs(cfg) == steps.batch_specs(cfg, mesh)
    jspec = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa: E731
    tspec = lambda x: isinstance(x, tshard.PartitionSpec)  # noqa: E731
    for shape_name in ("decode_32k", "long_500k"):
        shape = SHAPES[shape_name]
        jc = jax.eval_shape(functools.partial(jlm.init_cache, jcfg, shape.global_batch,
                                              shape.seq_len))
        tc = lm.init_cache(cfg, shape.global_batch, shape.seq_len, device="meta")
        want = _spec_paths(jsteps.cache_specs(jc, jcfg, shape, jmesh), jspec)
        got = _spec_paths(steps.cache_specs(tc, cfg, shape, mesh), tspec)
        assert got == want, shape_name
        # sanitize_spec over every cache leaf at its full shape
        shapes = {p: tuple(x.shape) for p, x in flatten_with_paths(tc)}
        for path, spec in want.items():
            assert tuple(steps.sanitize_spec(tshard.P(*spec), shapes[path], mesh)) == \
                tuple(jsteps.sanitize_spec(jax.sharding.PartitionSpec(*spec),
                                           shapes[path], jmesh)), (shape_name, path)
    # sanitize_spec over every parameter leaf's spec at its full shape
    meta = lm.init_params(cfg, device="meta")
    specs = _spec_paths(tshard.param_specs(meta, cfg.fsdp, mesh), tspec)
    for path, x in flatten_with_paths(meta):
        got = steps.sanitize_spec(tshard.P(*specs[path]), tuple(x.shape), mesh)
        want = jsteps.sanitize_spec(jax.sharding.PartitionSpec(*specs[path]),
                                    tuple(x.shape), jmesh)
        assert isinstance(got, tshard.PartitionSpec) and tuple(got) == tuple(want), path


@pytest.mark.parametrize("arch", ARCHS)
def test_optimized_and_serving_config_equal_reference(arch):
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    for mesh_name in MESHES:
        jmesh, mesh = _meshes(mesh_name)
        for shape in SHAPES.values():
            got = dataclasses.asdict(steps.optimized_config(cfg, shape, mesh))
            want = dataclasses.asdict(jsteps.optimized_config(jcfg, shape, jmesh))
            assert got == want, (mesh_name, shape.name)
        got = dataclasses.asdict(steps.serving_config(cfg, mesh))
        assert got == dataclasses.asdict(jsteps.serving_config(jcfg, jmesh)), mesh_name


@pytest.mark.parametrize("arch", ARCHS)
def test_model_counts_equal_reference(arch):
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    assert roofline.model_param_count(cfg) == jroof.model_param_count(jcfg)
    for seg_j, seg in zip(jcfg.segments, cfg.segments):
        for spec_j, spec in zip(seg_j.unit, seg.unit):
            assert roofline.layer_param_count(spec, cfg) == jroof.layer_param_count(spec_j, jcfg)
    for shape in SHAPES.values():
        for chips in (1, 256):
            assert roofline.model_flops(cfg, shape, chips) == \
                jroof.model_flops(jcfg, shape, chips), (shape.name, chips)


def test_roofline_rates_are_the_h100s():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (989e12, 3.35e12, 900e9)
    n = roofline.model_param_count(get_config("qwen3-1.7b"))[1]
    shape = SHAPES["train_4k"]
    one_seq = dataclasses.replace(shape, global_batch=1)
    assert roofline.model_flops(get_config("qwen3-1.7b"), one_seq, 1) == 6.0 * n * 4096
