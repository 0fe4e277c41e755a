"""Device meshes for the port: the counterpart of the mesh part of the JAX
package's `distributed/sharding.py`.

A `Mesh` is a named grid of `torch.device`s, held by ONE process: the
fabric (`distributed/fabric.py`) launches each shard's rows on that shard's
device from the calling thread, so no process group and no collective is
involved.  Axes follow the reference: ``("data", "model")`` on one pod,
``("pod", "data", "model")`` across pods.

A mesh may name a device more than once (``[torch.device("cpu")] * 8``, or
``cuda:0`` four times): the counterpart of XLA's forced host device count
(``--xla_force_host_platform_device_count``), which is how the reference's
tests build meshes of fake devices.  Each mesh position is still a shard of
its own — the fabric launches once per position, not once per distinct
device — so the mesh path runs the same code on the CPU, on one card and on
several.

Torch has no ``with mesh:``; `use_mesh` is a plain context manager over the
process-wide current mesh.  `PartitionSpec` and `NamedSharding` exist for
`checkpoint.restore(shardings=)` and the parameter rules: `param_specs` /
`param_shardings` give the reference's spec for every leaf of a parameter
tree (from its path and shape), and `constrain` / `constrain_batch` are the
identity (see there).  `NamedSharding.shard_shape` gives a leaf's piece on
each device, which is what the dry run (`launch/dryrun.py`) counts over a
mesh of repeated ``meta`` devices.  A leaf split across distinct devices has
no type in the port: `checkpoint.restore(shardings=)` refuses it (ROADMAP
A9d, an open item of its own).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any

import numpy as np
import torch

__all__ = ["Mesh", "make_mesh", "single_device_mesh", "set_global_mesh",
           "get_mesh", "use_mesh", "batch_axes", "local_batch",
           "PartitionSpec", "P", "NamedSharding", "sharding", "constrain",
           "constrain_batch", "param_specs", "param_shardings"]

_STATE: dict[str, Any] = {"mesh": None}


def _normalize(device) -> torch.device:
    """``cuda`` -> ``cuda:<current index>``, so that device comparisons and
    per-device caches agree; CUDA devices must exist.  ``meta`` (shapes
    only, no storage) is the dry run's device: a mesh of it stands for the
    reference's forced host devices."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"mesh device {device!r} requested but "
                "torch.cuda.is_available() is False")
        index = torch.cuda.current_device() if dev.index is None else dev.index
        if index >= torch.cuda.device_count():
            raise RuntimeError(f"mesh device cuda:{index} does not exist "
                               f"({torch.cuda.device_count()} visible)")
        return torch.device("cuda", index)
    if dev.type not in ("cpu", "meta"):
        raise ValueError(f"mesh devices must be CUDA devices, the CPU or meta, "
                         f"got {device!r}")
    return dev


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A named grid of devices.  ``devices`` is an object array of
    `torch.device` shaped like the mesh (one axis per name)."""

    axis_names: tuple[str, ...]
    devices: np.ndarray

    def __post_init__(self):
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"devices of shape {self.devices.shape} do not "
                             f"match axes {self.axis_names}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated axis name in {self.axis_names}")

    @property
    def shape(self) -> dict[str, int]:
        """Ordered ``{axis: size}``, as `jax.sharding.Mesh.shape`."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device_at(self, coords) -> torch.device:
        """The device at mesh position ``coords`` (one index per axis)."""
        return self.devices[tuple(coords)]

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.devices.reshape(-1)]})")


def make_mesh(shape, axes, devices=None) -> Mesh:
    """A mesh of ``shape`` over ``axes`` (counterpart of `make_mesh_compat`).

    Default devices: ``cuda:0 … cuda:n-1`` for n = prod(shape); raises when
    fewer cards are visible, as `jax.make_mesh` does.  An explicit
    ``devices`` list (row-major over the mesh) may name a device more than
    once — ``[torch.device("cpu")] * 8``, or ``cuda:0`` four times — the
    counterpart of XLA's forced host device count.
    """
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} differ in length")
    n = int(np.prod(shape, dtype=np.int64))
    if devices is None:
        visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if visible < n:
            raise RuntimeError(
                f"a mesh of shape {shape} needs {n} CUDA devices, "
                f"{visible} visible; pass devices= to repeat one")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = [_normalize(d) for d in devices]
    if len(devices) != n:
        raise ValueError(f"a mesh of shape {shape} needs {n} devices, "
                         f"got {len(devices)}")
    grid = np.empty((n,), dtype=object)
    grid[:] = devices
    return Mesh(axes, grid.reshape(shape))


def single_device_mesh(device=None) -> Mesh:
    """A (1, 1) mesh over ``("data", "model")`` on ``device`` (default: the
    current card)."""
    return make_mesh((1, 1), ("data", "model"),
                     devices=None if device is None else [device])


def set_global_mesh(mesh: Mesh | None) -> None:
    _STATE["mesh"] = mesh


def get_mesh() -> Mesh | None:
    return _STATE["mesh"]


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    """Make ``mesh`` the current mesh for the ``with`` body."""
    prev = _STATE["mesh"]
    _STATE["mesh"] = mesh
    try:
        yield mesh
    finally:
        _STATE["mesh"] = prev


def batch_axes(mesh: Mesh | None = None, pure_dp: bool = False) -> tuple:
    """The data-parallel axes of ``mesh`` (default: the current mesh)."""
    mesh = mesh or get_mesh()
    if mesh is None:
        return ()
    names = ("pod", "data", "model") if pure_dp else ("pod", "data")
    return tuple(a for a in names if a in mesh.axis_names)


def local_batch(global_batch: int, mesh: Mesh | None = None) -> int:
    """Per-replica batch: ``global_batch`` over the data-parallel ways."""
    mesh = mesh or get_mesh()
    if mesh is None:
        return global_batch
    n = int(np.prod([mesh.shape[a] for a in batch_axes(mesh)])) or 1
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} does not divide over "
                         f"{n} data-parallel ways")
    return global_batch // n


def _canonical_part(part):
    """One dimension's axes as `jax.sharding.PartitionSpec` stores them: a
    one-axis tuple or list is that axis, an empty one is None."""
    if isinstance(part, (tuple, list)):
        return None if not part else part[0] if len(part) == 1 else tuple(part)
    return part


class PartitionSpec(tuple):
    """Per-dimension mesh axes of an array (None: not split), as
    `jax.sharding.PartitionSpec`, canonicalized as it is."""

    def __new__(cls, *parts):
        return super().__new__(cls, (_canonical_part(p) for p in parts))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    """An array's placement: ``spec`` over ``mesh``."""

    mesh: Mesh
    spec: PartitionSpec

    def shard_shape(self, global_shape) -> tuple[int, ...]:
        """The shape of each device's piece of an array of ``global_shape``,
        as `jax.sharding.NamedSharding.shard_shape`: every split dimension
        divided by the product of its mesh axes, which must divide it."""
        shape = list(global_shape)
        if len(self.spec) > len(shape):
            raise ValueError(f"spec {self.spec} has more dimensions than "
                             f"shape {tuple(global_shape)}")
        for i, part in enumerate(self.spec):
            if part is None:
                continue
            n = math.prod(self.mesh.shape[a]
                          for a in (part if isinstance(part, tuple) else (part,)))
            if shape[i] % n:
                raise ValueError(f"dimension {i} of shape {tuple(global_shape)} "
                                 f"does not divide over {n} devices ({part!r})")
            shape[i] //= n
        return tuple(shape)


def sharding(spec: PartitionSpec, mesh: Mesh | None = None) -> NamedSharding:
    return NamedSharding(mesh or get_mesh(), spec)


def constrain(x, *spec_elems):
    """The reference's ``with_sharding_constraint`` under the current mesh:
    the identity here.  A constraint changes where XLA places a value, never
    the value, and in one process a torch tensor lives on exactly one
    device, so there is nothing to place."""
    return x


def constrain_batch(x, seq_shard: bool = False, pure_dp: bool = False):
    """The reference's batch-axis (and Megatron sequence-axis) constraint:
    the identity here, as `constrain`."""
    return x


# ---------------------------------------------------------------------------
# Parameter sharding rules (path-based), as the reference's.
# ---------------------------------------------------------------------------

def _leaf_spec(path: str, shape: tuple[int, ...], fsdp: bool, tp: int) -> PartitionSpec:
    """Sharding spec for one parameter, from its tree path and shape."""
    stacked = "segments" in path  # stacked params carry a leading repeats axis
    off = 1 if stacked else 0

    def fs(ax):  # data-axis (FSDP/ZeRO-3) shard for big dims only
        return "data" if (fsdp and shape[off + ax] >= 1024) else None

    name = path.split("/")[-2] if path.endswith("/w") or path.endswith("/b") else path.split("/")[-1]

    def pad(spec_tail: tuple) -> PartitionSpec:
        full = (None,) * off + spec_tail
        if len(full) != len(shape):
            raise ValueError(f"spec {full} does not fit {path} of shape {shape}")
        return PartitionSpec(*full)

    nd = len(shape) - off
    if path.endswith("/b") or nd == 1:  # biases, norms, scalars
        return pad((None,) * nd)
    if name in ("embed", "unembed"):
        # (V, d): vocab on model, d on data (fsdp)
        return pad(("model", fs(1)))
    if name in ("wq",):
        return pad((fs(0), "model"))
    if name in ("wk", "wv"):  # kv heads < TP on every assigned arch: replicate TP
        return pad((fs(0), None))
    if name in ("wo",):
        return pad(("model", fs(1)))
    if name in ("w_gate", "w_up", "w_in", "wx", "wgate", "wa", "wi_gate"):
        return pad((fs(0), "model"))
    if name in ("w_down", "w_out", "wo_proj"):
        return pad(("model", fs(1)))
    if name in ("w1", "w3"):  # MoE (E, d, F)
        return pad((None, fs(1), "model"))
    if name in ("w2",):       # MoE (E, F, d)
        return pad((None, "model", fs(2)))
    if name in ("wr",):       # router (d, E)
        return pad((None, None))
    if nd == 2:
        # generic 2D: TP on the trailing dim if it divides, FSDP on the other
        if shape[off + 1] % tp == 0 and shape[off + 1] >= tp:
            return pad((fs(0), "model"))
        return pad((fs(0), None))
    return pad((None,) * nd)


def param_specs(params_shape, fsdp: bool, mesh: Mesh | None = None, pure_dp: bool = False):
    """Tree of `PartitionSpec`s matching a params tree (leaves: anything with
    a ``.shape``, e.g. tensors on ``meta``)."""
    mesh = mesh or get_mesh()
    tp = mesh.shape["model"] if mesh is not None else 1

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, f"{path}/{i}") for i, v in enumerate(tree))
        spec = _leaf_spec(path, tuple(tree.shape), fsdp, tp)
        if pure_dp:  # no TP: drop "model"; widen FSDP shards to both axes
            elems = [None if el == "model" else el for el in spec]
            elems = [("data", "model") if el == "data" else el for el in elems]
            spec = PartitionSpec(*elems)
        return spec

    return walk(params_shape, "")


def param_shardings(params_shape, fsdp: bool, mesh: Mesh | None = None):
    """`param_specs` as `NamedSharding`s over ``mesh``."""
    mesh = mesh or get_mesh()

    def walk(tree):
        if isinstance(tree, PartitionSpec):
            return NamedSharding(mesh, tree)
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        return type(tree)(walk(v) for v in tree)

    return walk(param_specs(params_shape, fsdp, mesh))
