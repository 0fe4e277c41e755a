"""Trees of tensors, and leaves as bytes — the port's stand-in for `jax.tree`.

A tree is nested ``dict`` / ``list`` / ``tuple`` with leaves anywhere; ``None``
is an empty subtree (no leaf), as in `jax.tree`.  Dict keys are visited in
SORTED order, as `jax.tree.flatten` and the reference checkpoint's
`_flatten` do: leaf i of a checkpoint, an offload blob or a gradient frame
is then the same tensor in both packages.

Leaves cross to bytes with a dtype NAME that both packages write: the name
numpy gives the dtype (``str(np.dtype)``), so ``torch.bfloat16`` is
``"bfloat16"`` (the reference's `ml_dtypes` name) and travels as its int16
bits.  Leaves may be torch tensors (any device), numpy arrays or Python
scalars.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["flatten", "flatten_with_paths", "unflatten", "tree_map",
           "dtype_name", "torch_dtype", "leaf_bytes", "leaf_from_bytes",
           "target_device"]


class _Leaf:
    """Placeholder of a leaf in a tree definition."""

    __slots__ = ()

    def __repr__(self) -> str:
        return "*"


LEAF = _Leaf()


def flatten_with_paths(tree, path: str = ""):
    """Yield ``(path, leaf)`` in tree order; paths are ``/key/0/...`` as the
    reference checkpoint's manifest writes them."""
    if isinstance(tree, dict):
        for k in sorted(tree.keys()):
            yield from flatten_with_paths(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from flatten_with_paths(v, f"{path}/{i}")
    elif tree is None:
        return
    else:
        yield path, tree


def _structure(tree):
    if isinstance(tree, dict):
        return {k: _structure(tree[k]) for k in sorted(tree.keys())}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_structure(v) for v in tree)
    return None if tree is None else LEAF


def flatten(tree) -> tuple[list, object]:
    """``(leaves, treedef)``; `unflatten(treedef, leaves)` rebuilds the tree."""
    return [x for _, x in flatten_with_paths(tree)], _structure(tree)


def unflatten(treedef, leaves):
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node.keys())}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return None if node is None else next(it)

    out = build(treedef)
    if next(it, LEAF) is not LEAF:
        raise ValueError("more leaves than the tree definition holds")
    return out


def tree_map(fn, tree):
    """``fn`` over the leaves of ``tree``; the same structure back."""
    leaves, treedef = flatten(tree)
    return unflatten(treedef, [fn(x) for x in leaves])


# -- dtypes -------------------------------------------------------------------

def dtype_name(dtype) -> str:
    """Name both packages write for a torch or numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return str(np.dtype(dtype))


def torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise TypeError(f"no torch dtype named {name!r}")
    return dt


def _numpy_bits(name: str) -> np.dtype:
    """The numpy dtype that holds ``name``'s bits (bfloat16: int16)."""
    return np.dtype(np.int16) if name == "bfloat16" else np.dtype(name)


# -- leaves <-> bytes ---------------------------------------------------------

def leaf_bytes(x) -> tuple[np.ndarray, str, tuple[int, ...]]:
    """A leaf's bytes as an owned uint8 array, its dtype name and its shape.

    Always a COPY, taken before return: a CUDA tensor is copied to the host,
    a CPU tensor or numpy array is cloned, so an in-place update of the leaf
    afterwards cannot change the bytes (the async checkpoint writer relies
    on it)."""
    if isinstance(x, torch.Tensor):
        t = x.detach()
        host = t.to("cpu", copy=True) if t.device.type != "cpu" else t.clone()
        host = host.contiguous()
        name = dtype_name(t.dtype)
        bits = host.view(torch.int16) if t.dtype == torch.bfloat16 else host
        u8 = bits.numpy().reshape(-1).view(np.uint8)
        return u8, name, tuple(t.shape)
    a = np.array(x, copy=True, order="C")
    return a.reshape(-1).view(np.uint8), dtype_name(a.dtype), a.shape


def leaf_from_bytes(raw, name: str, shape, device) -> torch.Tensor:
    """bytes -> tensor of dtype ``name`` and ``shape`` on ``device``.  A size
    that does not match raises ValueError, as numpy's reshape does in the
    reference."""
    a = np.frombuffer(raw, dtype=_numpy_bits(name)).reshape(tuple(shape))
    t = torch.from_numpy(a.copy()).view(torch_dtype(name))
    return t if torch.device(device).type == "cpu" else t.to(device)


def target_device(like) -> torch.device:
    """Where a leaf restored against ``like`` goes: ``like``'s device, and
    the card for a ``meta`` tensor (a shape-and-dtype placeholder)."""
    if not isinstance(like, torch.Tensor):
        raise TypeError(f"expected a torch tensor as the leaf of `like`, got "
                        f"{type(like).__name__}")
    if like.device.type != "meta":
        return like.device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "a device=\"meta\" leaf of `like` restores to the card, and "
            "torch.cuda.is_available() is False; pass CPU tensors to restore "
            "on the CPU")
    return torch.device("cuda")
