"""The port's device-side emission against the reference's.

`_emit_layout` (`seg`, `fields`, `total`) and `emit_bytes` on CPU tensors vs
`repro.kernels.ops.emit_bytes` with ``use_pallas`` False and True (Pallas in
interpret mode), and ``out[:total]`` vs the host emitter.  Bytes and
integers: tolerance zero.  Match records come from the REFERENCE compressor,
so this file isolates the emit stage.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.jax_compressor import OUT_CAP, compress_block_records
from repro.kernels import ops as jops
from repro_torch import compat
from repro_torch.core.compressor import OUT_CAP as T_OUT_CAP
from repro_torch.core.emitter import emit_block
from repro_torch.kernels import emit_scatter as temit
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

from test_torch_util import adversarial_corpus, pad_stack

NAMES = [k for k in adversarial_corpus() if not k.startswith("short_")] \
    + ["short_13", "short_40"]
PALLAS_NAMES = ["text", "rle_to_boundary", "lit_ext_edge",
                "incompressible_short", "all_zero_short", "lit_nibble_edge2"]


@functools.lru_cache(maxsize=None)
def _reference(name: str):
    """Reference records + layout + bytes for one block (jit, no Pallas)."""
    data = adversarial_corpus()[name]
    stack, ns = pad_stack([data])
    n = jnp.int32(int(ns[0]))
    rec = compress_block_records(jnp.asarray(stack[0]), n)
    blk = jnp.asarray(stack[0], jnp.int32)
    seg, fields, total = jops._emit_layout(rec.emit, rec.pos, rec.length,
                                           rec.offset, n, OUT_CAP)
    out, total2 = jops.emit_bytes(blk, rec.emit, rec.pos, rec.length,
                                  rec.offset, n, out_cap=OUT_CAP)
    assert int(total) == int(total2)
    return dict(stack=stack, ns=ns,
                rec={k: np.asarray(getattr(rec, k))
                     for k in ("emit", "pos", "length", "offset", "size")},
                seg=np.asarray(seg), fields=np.asarray(fields),
                total=int(total), out=np.asarray(out))


@pytest.mark.parametrize("name", NAMES)
def test_layout_and_bytes_equal_reference(name):
    ref = _reference(name)
    rec = compat.records_from_numpy(**ref["rec"])
    ns = torch.from_numpy(ref["ns"])
    seg, fields, total = tops._emit_layout(rec.emit, rec.pos, rec.length,
                                           rec.offset, ns, T_OUT_CAP)
    assert seg.dtype == fields.dtype == total.dtype == torch.int32
    np.testing.assert_array_equal(seg[0].numpy(), ref["seg"])
    np.testing.assert_array_equal(fields[0].numpy(), ref["fields"])
    assert int(total[0]) == ref["total"] == int(ref["rec"]["size"])
    out, total2 = tops.emit_bytes(torch.from_numpy(ref["stack"]), rec.emit,
                                  rec.pos, rec.length, rec.offset, ns,
                                  out_cap=T_OUT_CAP)
    assert out.dtype == torch.uint8 and out.shape == (1, OUT_CAP)
    np.testing.assert_array_equal(out[0].numpy(), ref["out"])
    assert int(total2[0]) == ref["total"]
    # ... and the host oracle, byte for byte.
    data = adversarial_corpus()[name]
    r = ref["rec"]
    oracle = emit_block(data, r["emit"], r["pos"], r["length"], r["offset"],
                        len(data))
    assert out[0, : ref["total"]].numpy().tobytes() == oracle
    assert not out[0, ref["total"]:].any()


@pytest.mark.parametrize("name", PALLAS_NAMES)
def test_bytes_equal_pallas_interpret(name):
    ref = _reference(name)
    r = ref["rec"]
    n = jnp.int32(int(ref["ns"][0]))
    out_pl, total_pl = jops.emit_bytes(
        jnp.asarray(ref["stack"][0], jnp.int32), jnp.asarray(r["emit"]),
        jnp.asarray(r["pos"]), jnp.asarray(r["length"]),
        jnp.asarray(r["offset"]), n, out_cap=OUT_CAP, use_pallas=True)
    seg, fields, total = compat.layout_from_numpy(ref["seg"], ref["fields"],
                                                  ref["total"])
    out = temit.emit_scatter(torch.from_numpy(ref["stack"]), seg, fields, total)
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(out_pl))
    assert int(total_pl) == ref["total"]


def test_batched_emit_equals_per_block():
    """All blocks in ONE batched call == the per-block reference outputs."""
    refs = [_reference(k) for k in NAMES]
    rec = compat.records_from_numpy(**{
        k: np.stack([r["rec"][k] for r in refs])
        for k in ("emit", "pos", "length", "offset", "size")})
    stack = np.concatenate([r["stack"] for r in refs])
    ns = np.concatenate([r["ns"] for r in refs])
    # Garbage past n in the input must not reach the output.
    dirty, _ = pad_stack([adversarial_corpus()[k] for k in NAMES], garbage_seed=3)
    for blocks in (stack, dirty):
        out, total = tops.emit_bytes(torch.from_numpy(blocks), rec.emit, rec.pos,
                                     rec.length, rec.offset,
                                     torch.from_numpy(ns), out_cap=T_OUT_CAP)
        for j, r in enumerate(refs):
            np.testing.assert_array_equal(out[j].numpy(), r["out"], NAMES[j])
            assert int(total[j]) == r["total"]


_K = 640
_jit_emit_ref = jax.jit(jops.ref.emit_bytes_ref)


def _one_sequence_layout(lit: int, mlx: int, data_len: int):
    """Layout of: `lit` literals, one match of mlx + 4, then final literals."""
    def ext(v):
        return 0 if v < 15 else 1 + (v - 15) // 255
    size0 = 3 + ext(lit) + lit + ext(mlx)
    final_anchor = lit + mlx + 4
    final_lit = data_len - final_anchor
    total = size0 + 1 + ext(final_lit) + final_lit
    fields = np.zeros((tref.N_FIELDS, 2), np.int32)
    fields[:, 0] = [0, 0, lit, ext(lit), mlx, ext(mlx), 1, 1]
    fields[:, 1] = [size0, final_anchor, final_lit, ext(final_lit), 0, 0, 0, 0]
    seg = np.zeros((_K,), np.int32)   # fixed K: one jit of the reference
    seg[size0:] = 1
    return seg, fields, total


@pytest.mark.parametrize("lit", [14, 15, 16, 269, 270, 271])
@pytest.mark.parametrize("mlx", [14, 15, 16, 269, 270, 271])
def test_extension_byte_boundaries(lit, mlx):
    """Hand-built layouts at the boundaries of both extension runs, where a
    truncating modulus would differ from the reference's floor modulus."""
    r = np.random.default_rng(lit * 7 + mlx)
    head = r.integers(0, 256, lit, np.uint8).tobytes()
    data = head + head[-1:] * (mlx + 4) + b"tail-bytes"
    seg, fields, total = _one_sequence_layout(lit, mlx, len(data))
    stack, _ = pad_stack([data])
    out = temit.emit_scatter(torch.from_numpy(stack),
                             *compat.layout_from_numpy(seg, fields, total))
    oracle = emit_block(data, [True], [lit], [mlx + 4], [1], len(data))
    assert len(oracle) == total
    assert out[0, :total].numpy().tobytes() == oracle
    out_ref = _jit_emit_ref(jnp.asarray(stack[0], jnp.int32),
                                      jnp.asarray(seg), jnp.asarray(fields),
                                      jnp.int32(total))
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(out_ref))


def test_wrapper_checks_and_guards():
    ref = _reference("text")
    seg, fields, total = compat.layout_from_numpy(ref["seg"], ref["fields"],
                                                  ref["total"])
    blocks = torch.from_numpy(ref["stack"])
    before = temit.launches
    good = temit.emit_scatter(blocks, seg, fields, total)
    assert temit.launches == before           # the CPU path launches nothing
    assert temit.emit_scatter_plain is tref.emit_bytes_ref
    # An out-of-range seg is clamped, not a fault.
    bad_seg = seg.clone()
    bad_seg[0, -1] = 10 ** 6
    bad_seg[0, -2] = -5
    np.testing.assert_array_equal(
        temit.emit_scatter(blocks, bad_seg, fields, total).numpy(), good.numpy())
    with pytest.raises(TypeError):
        temit.emit_scatter(blocks.to(torch.int32), seg, fields, total)
    with pytest.raises(TypeError):
        temit.emit_scatter(blocks, seg.to(torch.int64), fields, total)
    with pytest.raises(ValueError):
        temit.emit_scatter(blocks, seg, fields[:, :7], total)
    with pytest.raises(ValueError):
        temit.emit_scatter(blocks, seg[0], fields, total)
