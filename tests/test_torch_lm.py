"""The port's language models (`repro_torch.models.lm`) against the JAX
package's (`repro.models.lm`) on the CPU, for all ten architectures at
``.reduced()``: the parameter tree (structure, shapes, dtypes; the ``meta``
shape tree at full size against `jax.eval_shape`), `forward_logits`,
`prefill` (logits and every cache leaf) and `decode_step` on the same
weights (the reference's `init_params`, carried over by
`params_from_numpy`) and the same seeded batch, tolerance 1e-4; NaN logits
for out-of-range token ids as `jnp.take` gives them; and `param_specs` at
full shapes on a (2, 2) mesh, with and without ``pure_dp``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import all_arch_names, get_config as jax_get_config
from repro.distributed import sharding as jshard
from repro.launch.inputs import make_batch as jax_make_batch
from repro.models import lm as jlm
from repro_torch._tree import flatten_with_paths
from repro_torch.configs.base import get_config
from repro_torch.distributed import sharding as tshard
from repro_torch.launch.inputs import make_batch
from repro_torch.models import lm
from repro_torch.models.convert import params_from_numpy

import test_torch_util  # noqa: F401  (one torch thread per worker)

ARCHS = all_arch_names()
B, S = 2, 32
TOL = dict(rtol=1e-4, atol=1e-4)
CPU = torch.device("cpu")


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def jax_paths(tree, is_leaf=None) -> dict:
    """path -> leaf, paths written as `_tree.flatten_with_paths` writes them."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]:
        parts = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        out["/" + "/".join(parts)] = leaf
    return out


def torch_paths(tree) -> dict:
    return dict(flatten_with_paths(tree))


def as_np(t):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


@functools.lru_cache(maxsize=None)
def setup(arch):
    """(config, reference params, port params, reference batch, port batch):
    the same weights and tokens in both packages."""
    jcfg = jax_get_config(arch).reduced()
    cfg = get_config(arch).reduced()
    jparams = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_numpy(np_tree(jparams), CPU)
    return (jcfg, cfg, jparams, params, jax_make_batch(1, jcfg, B, S),
            make_batch(1, cfg, B, S, device=CPU))


def assert_close_trees(got, want, what, **tol):
    g, w = torch_paths(got), jax_paths(want)
    assert list(g) == list(w), what
    for path in g:
        a, b = as_np(g[path]), np.asarray(w[path]).astype(as_np(g[path]).dtype)
        assert a.shape == b.shape, (what, path)
        np.testing.assert_allclose(a, b, err_msg=f"{what} {path}", **(tol or TOL))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_equals_reference(arch):
    jcfg, cfg, jparams, _, _, _ = setup(arch)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), device=CPU)
    got, want = torch_paths(params), jax_paths(jparams)
    assert list(got) == list(want)
    for path, leaf in got.items():
        assert tuple(leaf.shape) == want[path].shape, path
        assert str(leaf.dtype).removeprefix("torch.") == str(want[path].dtype), path
        assert leaf.device == CPU
    # the reference's scales: embed 0.02; linear 1/sqrt(d_in)
    assert abs(float(params["embed"].std()) - 0.02) < 0.002
    w = got["/segments/0/layers/0/ln1/scale"]
    assert torch.equal(w, torch.ones_like(w))
    # a different generator gives different weights, the same one the same
    again = lm.init_params(cfg, torch.Generator().manual_seed(0), device=CPU)
    other = lm.init_params(cfg, torch.Generator().manual_seed(1), device=CPU)
    assert torch.equal(again["embed"], params["embed"])
    assert not torch.equal(other["embed"], params["embed"])


@pytest.mark.parametrize("arch", ARCHS)
def test_meta_shape_tree_at_full_size_equals_eval_shape(arch):
    shapes = jax.eval_shape(lambda k: jlm.init_params(k, jax_get_config(arch)),
                            jax.random.PRNGKey(0))
    meta = lm.init_params(get_config(arch), device="meta")
    got, want = torch_paths(meta), jax_paths(shapes)
    assert list(got) == list(want)
    for path, leaf in got.items():
        assert leaf.device.type == "meta"
        assert tuple(leaf.shape) == want[path].shape, path
        assert str(leaf.dtype).removeprefix("torch.") == str(want[path].dtype), path
    with pytest.raises(ValueError, match="Generator"):
        lm.init_params(get_config(arch).reduced(), device=CPU)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_equal_reference(arch):
    jcfg, cfg, jparams, params, jbatch, batch = setup(arch)
    for k in jbatch:
        np.testing.assert_array_equal(as_np(batch[k]), np.asarray(jbatch[k]))
    with jshard.use_mesh(jshard.single_device_mesh()):
        want_logits = jax.jit(jlm.forward_logits, static_argnums=2)(jparams, jbatch, jcfg)
        jcache, want_pre = jax.jit(jlm.prefill, static_argnums=(2, 3))(
            jparams, jbatch, jcfg, S + 8)
        new_tok = jnp.full((B,), 7, jnp.int32)
        want_dec, jcache2 = jax.jit(jlm.decode_step, static_argnums=4)(
            jparams, jcache, new_tok, jcache["pos"], jcfg)
    got_logits = lm.forward_logits(params, batch, cfg)
    assert got_logits.shape == (B, S, cfg.vocab_size)
    np.testing.assert_allclose(as_np(got_logits), np.asarray(want_logits), **TOL)

    cache, got_pre = lm.prefill(params, batch, cfg, S + 8)
    np.testing.assert_allclose(as_np(got_pre), np.asarray(want_pre), **TOL)
    assert_close_trees(cache, jcache, f"{arch} prefill cache")
    assert cache["pos"].dtype == torch.int32 and int(cache["pos"]) == S

    before = {p: t.clone() for p, t in torch_paths(cache).items()}
    got_dec, cache2 = lm.decode_step(params, cache, torch.full((B,), 7, dtype=torch.int32),
                                     cache["pos"], cfg)
    np.testing.assert_allclose(as_np(got_dec), np.asarray(want_dec), **TOL)
    assert_close_trees(cache2, jcache2, f"{arch} decode cache")
    # decode_step leaves its input cache as it was
    for p, t in torch_paths(cache).items():
        assert torch.equal(t, before[p]), p


@pytest.mark.parametrize("ids", [[256, 3], [-1, -257]])
def test_out_of_range_token_gives_nan_as_jnp_take(ids):
    """`jnp.take` fills ids outside [-V, V) with NaN and wraps negative ones;
    `torch.embedding` would raise."""
    jcfg, cfg, jparams, params, jbatch, batch = setup("qwen3-1.7b")
    toks = np.asarray(jbatch["tokens"]).copy()
    toks[0, 5], toks[1, 9] = ids
    with jshard.use_mesh(jshard.single_device_mesh()):
        want = np.asarray(jax.jit(jlm.forward_logits, static_argnums=2)(
            jparams, {"tokens": jnp.asarray(toks)}, jcfg))
        jtok = jnp.asarray(np.array(ids, np.int32))
        jcache, _ = jax.jit(jlm.prefill, static_argnums=(2, 3))(jparams, jbatch, jcfg, S + 4)
        want_dec = np.asarray(jax.jit(jlm.decode_step, static_argnums=4)(
            jparams, jcache, jtok, jcache["pos"], jcfg)[0])
    got = as_np(lm.forward_logits(params, {"tokens": torch.from_numpy(toks)}, cfg))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got).any() == (ids[0] == 256 or ids[1] == -257)
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], **TOL)
    cache, _ = lm.prefill(params, batch, cfg, S + 4)
    got_dec = as_np(lm.decode_step(params, cache, torch.tensor(ids, dtype=torch.int32),
                                   cache["pos"], cfg)[0])
    np.testing.assert_array_equal(np.isnan(got_dec), np.isnan(want_dec))
    ok = ~np.isnan(want_dec)
    np.testing.assert_allclose(got_dec[ok], want_dec[ok], **TOL)


class _MeshShape:
    """What the reference's `param_specs` reads of a mesh: its axis sizes."""

    def __init__(self, shape):
        self.shape = shape


@pytest.mark.parametrize("pure_dp", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_reference_at_full_shapes(arch, pure_dp):
    jcfg = jax_get_config(arch)
    shapes = jax.eval_shape(lambda k: jlm.init_params(k, jcfg), jax.random.PRNGKey(0))
    meta = lm.init_params(get_config(arch), device="meta")
    mesh = tshard.make_mesh((2, 2), ("data", "model"), devices=[CPU] * 4)
    want = jax_paths(
        jshard.param_specs(shapes, jcfg.fsdp, _MeshShape({"data": 2, "model": 2}),
                           pure_dp=pure_dp),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    want = {path: tuple(spec) for path, spec in want.items()}
    specs = tshard.param_specs(meta, jcfg.fsdp, mesh, pure_dp=pure_dp)
    got = {}
    for path in torch_paths(meta):
        node = specs
        for part in path.strip("/").split("/"):
            node = node[int(part)] if isinstance(node, list) else node[part]
        assert isinstance(node, tshard.PartitionSpec), path
        got[path] = tuple(node)
    assert got == want
    if not pure_dp:
        with tshard.use_mesh(mesh):
            shardings = tshard.param_shardings(meta, jcfg.fsdp)
        assert shardings["embed"].mesh is mesh
        assert shardings["embed"].spec == specs["embed"]
        assert tuple(shardings["segments"][0]["layers"]["0"]["ln1"]["scale"].spec) == \
            want["/segments/0/layers/0/ln1/scale"]
