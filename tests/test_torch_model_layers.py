"""The port's model building blocks (`repro_torch.models.{layers,attention,
moe,recurrent}`) against the JAX package's on the CPU, on the same seeded
numpy inputs and the reference's own initial weights.

Tolerances: ``atol = rtol = 1e-5`` for the float32 units, ``1e-4`` for the
scans (the RG-LRU's log-step scan against the reference's associative scan,
the mLSTM chunk and step forms, the sLSTM loop).  MoE dispatch is checked
with drops, with tied router logits (`jax.lax.top_k` takes the lower index)
and on a 2-position data mesh, against the reference on 2 forced host
devices in one subprocess.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.distributed import sharding as jshard
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models import recurrent as jrec
from repro_torch.configs.base import get_config
from repro_torch.distributed import sharding as tshard
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import moe as tmoe
from repro_torch.models import recurrent as trec
from repro_torch.models.convert import params_from_numpy

import test_torch_util  # noqa: F401  (one torch thread per worker)

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
UNIT = dict(rtol=1e-5, atol=1e-5)
SCAN = dict(rtol=1e-4, atol=1e-4)


def rng(seed):
    return np.random.default_rng(seed)


def normal(seed, shape, scale=1.0):
    return (rng(seed).normal(0, 1, shape) * scale).astype(np.float32)


def both(a):
    """(jax array, torch tensor) of one numpy array."""
    return jnp.asarray(a), torch.from_numpy(np.array(a, copy=True))


def as_np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def close(got, want, tol=UNIT, what=""):
    np.testing.assert_allclose(as_np(got), as_np(want), err_msg=what, **tol)


def close_trees(got: dict, want: dict, tol=UNIT):
    assert sorted(got) == sorted(want)
    for k in got:
        close(got[k], want[k], tol, k)


def weights(jtree):
    """The reference's init output, and the port's copy of it."""
    return jtree, params_from_numpy(jax.tree.map(np.asarray, jtree), CPU)


def cfg_of(arch, **kw):
    """(reference config, port config): `arch` reduced, fields replaced."""
    return (dataclasses.replace(jax_get_config(arch).reduced(), **kw),
            dataclasses.replace(get_config(arch).reduced(), **kw))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layer_norm", [False, True])
def test_apply_norm(layer_norm):
    jx, tx = both(normal(0, (2, 5, 64), 3.0))
    p = {"scale": normal(1, (64,)) + 1.0}
    if layer_norm:
        p["bias"] = normal(2, (64,))
    jp, tp = jax.tree.map(jnp.asarray, p), params_from_numpy(p, CPU)
    close(tlayers.apply_norm(tp, tx, 1e-6, layer_norm),
          jlayers.apply_norm(jp, jx, 1e-6, layer_norm))
    # computed in float32, cast back
    got = tlayers.apply_norm(tp, tx.to(torch.bfloat16), 1e-6, layer_norm)
    want = jlayers.apply_norm(jp, jx.astype(jnp.bfloat16), 1e-6, layer_norm)
    assert got.dtype == torch.bfloat16
    close(got.float(), want.astype(jnp.float32), dict(rtol=1e-2, atol=1e-2))


@pytest.mark.parametrize("gated", [True, False])
def test_apply_mlp(gated):
    jp, tp = weights(jlayers.mlp_init(jax.random.PRNGKey(3), 64, 96, use_bias=not gated,
                                      gated=gated))
    jx, tx = both(normal(4, (2, 7, 64)))
    close(tlayers.apply_mlp(tp, tx), jlayers.apply_mlp(jp, jx))


@pytest.mark.parametrize("theta", [10000.0, 1e6])
def test_rope_splits_halves(theta):
    jx, tx = both(normal(5, (2, 9, 3, 16)))
    pos = rng(6).integers(0, 5000, (2, 9)).astype(np.int32)
    jpos, tpos = both(pos)
    close(tlayers.rope(tx, tpos, theta), jlayers.rope(jx, jpos, theta), SCAN)
    # decode's positions: one absolute position, broadcast over the batch
    close(tlayers.rope(tx[:, :1], torch.full((2, 1), 77), theta),
          jlayers.rope(jx[:, :1], jnp.full((2, 1), 77), theta))


@pytest.mark.parametrize("d,offset", [(64, 0), (64, 13), (2, 0), (3, 5)])
def test_sinusoidal_positions(d, offset):
    close(tlayers.sinusoidal_positions(11, d, offset=offset),
          jlayers.sinusoidal_positions(11, d, offset=offset), SCAN)


@pytest.mark.parametrize("cap", [None, 30.0])
def test_softcap(cap):
    jx, tx = both(normal(7, (4, 50), 40.0))
    close(tlayers.softcap(tx, cap), jlayers.softcap(jx, cap))


@pytest.mark.parametrize("chunk", [16, 7, 4096])
def test_cross_entropy_chunked(chunk):
    w = normal(8, (32, 50))
    jw, tw = both(w)
    jx, tx = both(normal(9, (3, 11, 32)))
    labels = rng(10).integers(0, 50, (3, 11)).astype(np.int32)
    mask = (rng(11).random((3, 11)) > 0.3).astype(np.float32)
    jl, tl = both(labels)
    jm, tm = both(mask)
    close(tlayers.cross_entropy_chunked(lambda xc: xc @ tw, tx, tl, tm, 50, chunk),
          jlayers.cross_entropy_chunked(lambda xc: xc @ jw, jx, jl, jm, 50, chunk))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def qkv(seed, S=24, Sk=None, H=4, hd=16):
    Sk = Sk or S
    return [both(normal(seed + i, (2, n, H, hd))) for i, n in enumerate((S, Sk, Sk))]


@pytest.mark.parametrize("arch,masked", [("qwen3-1.7b", True), ("gemma2-9b", True),
                                         ("qwen3-1.7b", False)])
def test_sdpa(arch, masked):
    jcfg, cfg = cfg_of(arch)
    (jq, tq), (jk, tk), (jv, tv) = qkv(20)
    mask = rng(21).random((24, 24)) > 0.4 if masked else None
    mask_j = None if mask is None else jnp.asarray(mask)
    mask_t = None if mask is None else torch.from_numpy(mask)
    close(tattn._sdpa(tq, tk, tv, mask_t, cfg), jattn._sdpa(jq, jk, jv, mask_j, jcfg))


@pytest.mark.parametrize("local", [False, True])
@pytest.mark.parametrize("q_chunk", [512, 8])
def test_causal_chunked(local, q_chunk, monkeypatch):
    """Exact KV slices per query chunk; a chunk of 8 with a window of 12
    cuts bands that start inside the sequence."""
    monkeypatch.setattr(jattn, "Q_CHUNK", q_chunk)
    monkeypatch.setattr(tattn, "Q_CHUNK", q_chunk)
    jcfg, cfg = cfg_of("gemma2-9b", window=12)
    (jq, tq), (jk, tk), (jv, tv) = qkv(30, S=32)
    close(tattn._causal_chunked(tq, tk, tv, cfg, local),
          jattn._causal_chunked(jq, jk, jv, jcfg, local))
    if q_chunk < 32:
        with pytest.raises(ValueError, match="multiple"):
            tattn._causal_chunked(tq[:, :30], tk[:, :30], tv[:, :30], cfg, local)


@pytest.mark.parametrize("arch,attn_type", [("qwen3-1.7b", "global"),
                                            ("gemma2-9b", "local"),
                                            ("whisper-small", "bidir")])
def test_multihead_attention(arch, attn_type):
    jcfg, cfg = cfg_of(arch)
    jp, tp = weights(jattn.attention_init(jax.random.PRNGKey(31), jcfg))
    jx, tx = both(normal(32, (2, 20, 64)))
    with jshard.use_mesh(jshard.single_device_mesh()):
        want, (wk, wv) = jattn.multihead_attention(jp, jx, jcfg, attn_type)
    got, (gk, gv) = tattn.multihead_attention(tp, tx, cfg, attn_type)
    close(got, want)
    close(gk, wk)
    close(gv, wv)
    if arch == "whisper-small":  # cross attention over a memory
        jm, tm = both(normal(33, (2, 16, 64)))
        want, _ = jattn.multihead_attention(jp, jx, jcfg, "bidir", memory=jm)
        got, _ = tattn.multihead_attention(tp, tx, cfg, "bidir", memory=tm)
        close(got, want)


@pytest.mark.parametrize("size,S", [(40, 24), (24, 24), (16, 24), (8, 3)])
def test_fill_cache_full_and_rolling(size, S):
    jcfg, cfg = cfg_of("gemma2-9b", window=size)
    jc = jattn.make_cache(jcfg, "local", 2, 64, jnp.float32)
    tc = tattn.make_cache(cfg, "local", 2, 64, torch.float32)
    close_trees(tc, jc)
    (_, _), (jk, tk), (jv, tv) = qkv(40, S=S, H=2)
    want = jattn.fill_cache(jc, jk, jv, 0)
    got = tattn.fill_cache(tc, tk, tv, 0)
    close_trees(got, want)
    assert got["pos"].dtype == torch.int32
    assert not tc["k"].any()  # the input cache is not modified


def _decode_case(arch, attn_type, mode, window, seed):
    jcfg, cfg = cfg_of(arch, cache_update=mode, window=window)
    jp, tp = weights(jattn.attention_init(jax.random.PRNGKey(seed), jcfg))
    (_, _), (jk, tk), (jv, tv) = qkv(seed + 1, S=20, H=cfg.n_kv_heads)
    jc = jattn.fill_cache(jattn.make_cache(jcfg, attn_type, 2, 24, jnp.float32), jk, jv)
    tc = tattn.fill_cache(tattn.make_cache(cfg, attn_type, 2, 24, torch.float32), tk, tv)
    jx, tx = both(normal(seed + 5, (2, 1, 64)))
    outs = []
    for pos in (20, 23, 30):  # the last one wraps a rolling cache
        want, jc = jattn.decode_attention(jp, jx, jcfg, jc, jnp.int32(pos), attn_type)
        got, tc = tattn.decode_attention(tp, tx, cfg, tc, pos, attn_type)
        close(got, want, what=f"pos {pos}")
        close_trees(tc, jc)
        outs.append(got)
    return outs, tc


@pytest.mark.parametrize("mode", ["dus", "masked"])
@pytest.mark.parametrize("arch,attn_type,window", [("qwen3-1.7b", "global", 4096),
                                                   ("gemma2-9b", "local", 12),
                                                   ("gemma2-9b", "local", 24)])
def test_decode_attention(mode, arch, attn_type, window):
    _decode_case(arch, attn_type, mode, window, seed=50)


def test_decode_attention_update_modes_agree():
    dus, c_dus = _decode_case("gemma2-9b", "local", "dus", 12, seed=60)
    masked, c_masked = _decode_case("gemma2-9b", "local", "masked", 12, seed=60)
    for a, b in zip(dus, masked):
        assert torch.equal(a, b)
    for k in c_dus:
        assert torch.equal(c_dus[k], c_masked[k])


def test_decode_cross_attention():
    jcfg, cfg = cfg_of("whisper-small")
    jp, tp = weights(jattn.attention_init(jax.random.PRNGKey(70), jcfg))
    (_, _), (jk, tk), (jv, tv) = qkv(71, S=16)
    jx, tx = both(normal(74, (2, 1, 64)))
    want, _ = jattn.decode_attention(jp, jx, jcfg, None, jnp.int32(5), "bidir",
                                     memory_cache={"k": jk, "v": jv})
    got, _ = tattn.decode_attention(tp, tx, cfg, None, 5, "bidir",
                                    memory_cache={"k": tk, "v": tv})
    close(got, want)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def moe_case(seed, T=(2, 12), capacity_factor=8.0, tie=None):
    jcfg, cfg = cfg_of("mixtral-8x7b", capacity_factor=capacity_factor)
    p = jax.tree.map(np.array, jmoe.moe_init(jax.random.PRNGKey(seed), jcfg))
    if tie == "all":        # every router logit 0: top-2 is experts 0 and 1
        p["wr"]["w"] = np.zeros_like(p["wr"]["w"])
    elif tie == "pair":     # experts 1 and 3 always tie
        p["wr"]["w"][:, 3] = p["wr"]["w"][:, 1]
    jp, tp = weights(jax.tree.map(jnp.asarray, p))
    jx, tx = both(normal(seed + 1, T + (64,)))
    return jcfg, cfg, jp, tp, jx, tx


@pytest.mark.parametrize("case", [dict(), dict(capacity_factor=1.0),
                                  dict(capacity_factor=0.5, T=(3, 20)),
                                  dict(tie="all"), dict(tie="pair"),
                                  dict(tie="all", capacity_factor=8.0, T=(1, 3))])
def test_local_moe(case):
    jcfg, cfg, jp, tp, jx, tx = moe_case(80, **case)
    args = lambda p: (p["wr"]["w"], p["w1"]["w"], p["w3"]["w"], p["w2"]["w"])  # noqa: E731
    want, want_aux = jmoe._local_moe(jx, *args(jp), jcfg, fsdp=False, tp=False)
    got, got_aux = tmoe._local_moe(tx, *args(tp), cfg)
    close(got, want)
    close(got_aux, want_aux)


@pytest.mark.parametrize("case", [dict(), dict(tie="all"), dict(tie="pair")])
def test_dense_moe(case):
    jcfg, cfg, jp, tp, jx, tx = moe_case(90, **case)
    want, want_aux = jmoe._dense_moe(jp, jx, jcfg)
    got, got_aux = tmoe._dense_moe(tp, tx, cfg)
    close(got, want)
    close(got_aux, want_aux)


def test_top_k_takes_the_lower_index_on_ties():
    x = np.array([[1.0, 3.0, 3.0, 0.5, 3.0], [2.0, 2.0, 2.0, 2.0, 2.0]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 3)
    tv, ti = tmoe.top_k(torch.from_numpy(x), 3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert ti.tolist() == [[1, 2, 4], [0, 1, 2]]


def test_moe_ffn_without_mesh_is_one_shard():
    jcfg, cfg, jp, tp, jx, tx = moe_case(100, capacity_factor=1.0)
    with jshard.use_mesh(jshard.single_device_mesh()):
        want, want_aux = jmoe.moe_ffn(jp, jx, jcfg)
    got, got_aux = tmoe.moe_ffn(tp, tx, cfg)
    close(got, want)
    close(got_aux, want_aux)


_MESH_REFERENCE = textwrap.dedent("""
    import dataclasses, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs.base import get_config
    from repro.distributed.sharding import make_mesh_compat, use_mesh
    from repro.models import moe

    out = sys.argv[1]
    assert len(jax.devices()) == 2
    res = {}
    for cf in (1.0, 8.0):
        cfg = dataclasses.replace(get_config("mixtral-8x7b").reduced(), capacity_factor=cf)
        p = moe.moe_init(jax.random.PRNGKey(110), cfg)
        for B in (2, 4, 3):   # B = 3 does not divide over 2 shards: the dense path
            x = jnp.asarray(np.random.default_rng(B).normal(0, 1, (B, 10, 64)), jnp.float32)
            with use_mesh(make_mesh_compat((2, 1), ("data", "model"))):
                y, aux = jax.jit(moe.moe_ffn, static_argnums=2)(p, x, cfg)
            res[f"y_{cf}_{B}"] = np.asarray(y)
            res[f"aux_{cf}_{B}"] = np.asarray(aux)
    np.savez(out, **res)
""")


@pytest.fixture(scope="module")
def moe_mesh_reference(tmp_path_factory):
    """The reference's `moe_ffn` on a (2, 1) mesh of 2 forced host devices."""
    out = tmp_path_factory.mktemp("moe_ref") / "moe.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT / 'tests'}")
    proc = subprocess.run([sys.executable, "-c", _MESH_REFERENCE, str(out)],
                          capture_output=True, text=True, timeout=600, env=env,
                          cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(out))


@pytest.mark.parametrize("cf", [1.0, 8.0])
@pytest.mark.parametrize("B", [2, 4, 3])
def test_moe_ffn_on_a_data_mesh_equals_reference(moe_mesh_reference, cf, B):
    """Capacity is counted per data-parallel shard: on a (2, 1) mesh the
    port gives the reference's values on the same mesh (and at capacity
    factor 1 not those of one shard)."""
    jcfg, cfg = cfg_of("mixtral-8x7b", capacity_factor=cf)
    jp, tp = weights(jmoe.moe_init(jax.random.PRNGKey(110), jcfg))
    x = np.random.default_rng(B).normal(0, 1, (B, 10, 64)).astype(np.float32)
    mesh = tshard.make_mesh((2, 1), ("data", "model"), devices=[CPU] * 2)
    with tshard.use_mesh(mesh):
        got, got_aux = tmoe.moe_ffn(tp, torch.from_numpy(x), cfg)
    close(got, moe_mesh_reference[f"y_{cf}_{B}"])
    close(got_aux, moe_mesh_reference[f"aux_{cf}_{B}"])
    one_shard, _ = tmoe.moe_ffn(tp, torch.from_numpy(x), cfg)
    if cf == 1.0 and B != 3:
        assert not torch.allclose(got, one_shard, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# recurrent mixers
# ---------------------------------------------------------------------------

def test_causal_conv():
    jx, tx = both(normal(120, (2, 9, 8)))
    jw, tw = both(normal(121, (4, 8)))
    close(trec._causal_conv(tx, tw), jrec._causal_conv(jx, jw))


@pytest.mark.parametrize("S", [1, 5, 16, 33])
def test_lru_scan(S):
    a = rng(122).uniform(0.5, 1.0, (2, S, 8)).astype(np.float32)
    ja, ta = both(a)
    jb, tb = both(normal(123, (2, S, 8)))
    close(trec._lru_scan(ta, tb), jrec._lru_scan(ja, jb), SCAN)


def test_rglru_block_and_step():
    jcfg, cfg = cfg_of("recurrentgemma-9b")
    jp, tp = weights(jrec.rglru_init(jax.random.PRNGKey(124), jcfg))
    jx, tx = both(normal(125, (2, 12, 64)))
    want, wstate = jrec.rglru_block(jp, jx, jcfg)
    got, gstate = trec.rglru_block(tp, tx, cfg)
    close(got, want, SCAN)
    close_trees(gstate, wstate, SCAN)
    jst = jrec.rglru_state_init(jcfg, 2, jnp.float32)
    tst = trec.rglru_state_init(cfg, 2, torch.float32)
    close_trees(tst, jst)
    for t in range(3):
        wy, jst = jrec.rglru_step(jp, jx[:, t: t + 1], jcfg, jst)
        gy, tst = trec.rglru_step(tp, tx[:, t: t + 1], cfg, tst)
        close(gy, wy, SCAN)
        close_trees(tst, jst, SCAN)


def mlstm_inputs(S, seed=130, H=3, p=8):
    q, k, v = (both(normal(seed + i, (2, S, H, p))) for i in range(3))
    i_g = both(normal(seed + 3, (2, S, H)))
    f_g = both((rng(seed + 4).normal(2, 1, (2, S, H))).astype(np.float32))
    return q, k, v, i_g, f_g


@pytest.mark.parametrize("S,chunk", [(64, 16), (32, 256), (24, 8)])
def test_mlstm_chunk_and_sequential(S, chunk):
    args = mlstm_inputs(S)
    jargs = [a for a, _ in args]
    targs = [b for _, b in args]
    wh, (wC, wn, wm) = jrec._mlstm_chunk(*jargs, chunk=chunk)
    gh, (gC, gn, gm) = trec._mlstm_chunk(*targs, chunk=chunk)
    close(gh, wh, SCAN)
    for g, w in ((gC, wC), (gn, wn), (gm, wm)):
        close(g, w, SCAN)
    wh_s, wfin = jrec._mlstm_sequential(*jargs)
    gh_s, gfin = trec._mlstm_sequential(*targs)
    close(gh_s, wh_s, SCAN)
    close_trees(gfin, wfin, SCAN)
    close(gh, gh_s, SCAN)   # the port's two forms agree with each other too


def test_mlstm_block_and_step():
    jcfg, cfg = cfg_of("xlstm-125m")
    jp, tp = weights(jrec.mlstm_init(jax.random.PRNGKey(140), jcfg))
    jx, tx = both(normal(141, (2, 16, 64)))
    want, wstate = jrec.mlstm_block(jp, jx, jcfg, chunk=8)
    got, gstate = trec.mlstm_block(tp, tx, cfg, chunk=8)
    close(got, want, SCAN)
    close_trees(gstate, wstate, SCAN)
    wy, wst = jrec.mlstm_block_step(jp, jx[:, :1], jcfg, wstate)
    gy, gst = trec.mlstm_block_step(tp, tx[:, :1], cfg, gstate)
    close(gy, wy, SCAN)
    close_trees(gst, wst, SCAN)
    close_trees(trec.mlstm_state_init(cfg, 2, torch.float32),
                jrec.mlstm_state_init(jcfg, 2, jnp.float32))


def test_slstm_block_and_step():
    jcfg, cfg = cfg_of("xlstm-125m")
    jp, tp = weights(jrec.slstm_init(jax.random.PRNGKey(150), jcfg))
    jx, tx = both(normal(151, (2, 10, 64)))
    want, wstate = jrec.slstm_block(jp, jx, jcfg)
    got, gstate = trec.slstm_block(tp, tx, cfg)
    close(got, want, SCAN)
    close_trees(gstate, wstate, SCAN)
    wy, wst = jrec.slstm_block_step(jp, jx[:, :1], jcfg, wstate)
    gy, gst = trec.slstm_block_step(tp, tx[:, :1], cfg, gstate)
    close(gy, wy, SCAN)
    close_trees(gst, wst, SCAN)
