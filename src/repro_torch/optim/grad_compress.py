"""Gradient compression: int8 quantization with error feedback, and gradient
frames at the host boundary.

The port of the JAX package's `optim/grad_compress.py`:
  * quantize_with_error_feedback — int8-quantize each gradient tensor with a
    per-tensor scale; the residual is carried to the next step.  Torch ops on
    the tensors' own device, the reference's arithmetic in float32.
  * compressed_psum_pod — the int8 all-reduce over the "pod" axis of the
    current mesh (quantize -> sum int32 codes -> dequantize).  The
    reference runs it in `shard_map` with `psum`; here one process quantizes
    each pod position's copy on that position's device and sums the codes.
  * export_gradient_frame / import_gradient_frame — a gradient tree
    flattened (sorted dict keys, as `jax.tree`) to one byte stream and
    compressed through an `LZ4Engine` into one self-describing frame, for
    cross-host shipping, gradient logging or straggler replay; the frame is
    byte-identical to the reference's for the same tree.
"""
from __future__ import annotations

import torch

from repro_torch._tree import (
    dtype_name,
    flatten,
    leaf_bytes,
    leaf_from_bytes,
    target_device,
    tree_map,
    unflatten,
)

__all__ = ["ef_init", "quantize_with_error_feedback", "compressed_psum_pod",
           "pod_sum_codes", "export_gradient_frame", "import_gradient_frame"]


def ef_init(params):
    """Zero float32 error-feedback state shaped like ``params``."""
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)


def quantize_with_error_feedback(grads, ef):
    """int8-quantize each gradient tensor; the residual goes into `ef`.
    Returns ``(dequantized grads in their own dtype, new ef)``."""

    def leaf(g, e):
        g32 = g.to(torch.float32) + e
        scale = torch.clamp_min(g32.abs().max(), 1e-12) / 127.0
        q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
        deq = q.to(torch.float32) * scale
        return deq.to(g.dtype), g32 - deq

    leaves, treedef = flatten(grads)
    out = [leaf(g, e) for g, e in zip(leaves, flatten(ef)[0])]
    return (unflatten(treedef, [g for g, _ in out]),
            unflatten(treedef, [e for _, e in out]))


def pod_sum_codes(x: torch.Tensor, mesh) -> tuple[list, list]:
    """The int8 wire format of `compressed_psum_pod`, per chunk of ``x``.

    ``x`` is split along dim 0 over the first non-pod axis of ``mesh`` (one
    chunk when there is none) and replicated over "pod".  For each chunk,
    every pod position quantizes its copy on its own device with the scale
    shared across pods (the max of ``max(|chunk|, 1e-12) / 127``), and the
    int32 codes are summed over pods on pod 0's device.  Returns
    ``(totals, scales)``: per chunk the summed codes and the scale.
    """
    rest = [a for a in mesh.axis_names if a != "pod"]
    ways = mesh.shape[rest[0]] if rest else 1
    if x.shape[0] % ways:
        raise ValueError(f"dim 0 of size {x.shape[0]} does not split over "
                         f"{ways} positions of axis {rest[0]!r}")
    size = x.shape[0] // ways
    pod = mesh.axis_names.index("pod")
    split = mesh.axis_names.index(rest[0]) if rest else None
    totals, scales = [], []
    for c in range(ways):
        devs = []
        for p in range(mesh.shape["pod"]):
            coords = [0] * len(mesh.axis_names)
            coords[pod] = p
            if split is not None:
                coords[split] = c
            devs.append(mesh.device_at(coords))
        vs = [x[c * size: (c + 1) * size].to(d) for d in devs]
        local = [torch.clamp_min(v.abs().max(), 1e-12) / 127.0 for v in vs]
        scale = torch.stack([s.to(devs[0]) for s in local]).max()
        codes = [torch.clamp(torch.round(v / scale.to(v.device)), -127, 127)
                 .to(torch.int32) for v in vs]
        totals.append(torch.stack([q.to(devs[0]) for q in codes])
                      .sum(0, dtype=torch.int32))
        scales.append(scale)
    return totals, scales


def compressed_psum_pod(x: torch.Tensor) -> torch.Tensor:
    """int8 all-reduce over the "pod" axis of the current mesh.

    ``x`` is replicated over "pod"; returns the pod-sum computed through an
    int8 wire format (a quarter of float32's bytes), on ``x``'s device.
    Without a mesh, or without a "pod" axis, returns ``x``.
    """
    from repro_torch.distributed.sharding import get_mesh

    mesh = get_mesh()
    if mesh is None or "pod" not in mesh.axis_names:
        return x
    totals, scales = pod_sum_codes(x, mesh)
    return torch.cat([(t.to(torch.float32) * s).to(x.device)
                      for t, s in zip(totals, scales)])


def export_gradient_frame(grads, engine=None) -> bytes:
    """Flatten a gradient tree into ONE compressed frame (host boundary).

    Leaves are copied to the host in tree order and concatenated into a
    single byte stream, then compressed in one engine call (``engine``, or
    `default_engine()` on the card) so every block rides the micro-batched
    datapath.  Block CRCs make in-flight corruption of a shipped gradient
    loud instead of silently diverging a replica.
    """
    from repro_torch.core.engine import default_engine

    raw = b"".join(leaf_bytes(g)[0].tobytes() for g in flatten(grads)[0])
    return (engine or default_engine()).compress(raw)


def import_gradient_frame(frame: bytes, like, decode_engine=None):
    """Inverse of `export_gradient_frame`: frame -> tree shaped like
    ``like`` (shapes and dtypes from its leaves; each leaf lands on its
    ``like`` leaf's device, the card for ``meta``).  Decoded by
    ``decode_engine`` (default: `default_decode_engine()`, on the card)."""
    from repro_torch.core.decode_engine import default_decode_engine

    raw = (decode_engine or default_decode_engine()).decode(frame)
    leaves, treedef = flatten(like)
    out, off = [], 0
    for leaf in leaves:
        nb = leaf.dtype.itemsize * leaf.numel()
        out.append(leaf_from_bytes(raw[off: off + nb], dtype_name(leaf.dtype),
                                   tuple(leaf.shape), target_device(leaf)))
        off += nb
    if off != len(raw):
        raise ValueError(
            f"frame holds {len(raw)} bytes, pytree expects {off}")
    return unflatten(treedef, out)
