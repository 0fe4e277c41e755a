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
mesh of repeated ``meta`` devices.

`device_put` is the counterpart of ``jax.device_put(x, NamedSharding)``: on
a mesh of one distinct device it returns a plain tensor there; on a mesh of
distinct devices a `ShardedTensor`, one `Shard` per mesh position (its
`NamedSharding.shard_indices` slice, copied to that position's device).  A
`ShardedTensor` is the form in which a later multi-card step would take its
state; today only `checkpoint.restore(shardings=)` makes one, and no step
of `launch/` takes one (nor does the reference's `launch/` restore with
shardings).
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
           "constrain_batch", "param_specs", "param_shardings",
           "check_sharding", "Shard", "ShardedTensor", "device_put"]

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

    def shard_indices(self, global_shape) -> list[tuple[slice, ...]]:
        """One tuple of slices per mesh position, in the mesh's row-major
        order: where that position's piece of an array of ``global_shape``
        lies, as `jax.sharding.NamedSharding.devices_indices_map` gives it
        per device (``slice(None)`` for a dimension that is not split).  Keyed
        by position, not device, because a mesh may repeat a device.  A
        dimension split over a tuple of axes is split over the product of
        their sizes, the first axis major."""
        piece = self.shard_shape(global_shape)
        sizes = self.mesh.shape
        out = []
        for coords in np.ndindex(*self.mesh.devices.shape):
            at = dict(zip(self.mesh.axis_names, coords))
            index = []
            for i, n in enumerate(piece):
                part = self.spec[i] if i < len(self.spec) else None
                if part is None:
                    index.append(slice(None))
                    continue
                k = 0
                for a in (part if isinstance(part, tuple) else (part,)):
                    k = k * sizes[a] + at[a]
                index.append(slice(k * n, (k + 1) * n))
            out.append(tuple(index))
        return out


def check_sharding(sh, what: str = "sharding") -> NamedSharding:
    """``sh`` if it is a `NamedSharding` whose spec names only axes of its
    mesh; else TypeError / ValueError naming ``what``."""
    if not isinstance(sh, NamedSharding):
        raise TypeError(f"{what} must be a repro_torch NamedSharding, "
                        f"got {type(sh).__name__}")
    for part in sh.spec:
        for axis in (part if isinstance(part, tuple) else (part,)):
            if axis is not None and axis not in sh.mesh.axis_names:
                raise ValueError(f"{what}: axis {axis!r} not in mesh "
                                 f"{sh.mesh.axis_names}")
    return sh


@dataclasses.dataclass(frozen=True, eq=False)
class Shard:
    """One mesh position's piece of a `ShardedTensor`: ``data`` (contiguous,
    on ``device``; shape only on ``meta``) is the global tensor at
    ``index``."""

    device: torch.device
    index: tuple[slice, ...]
    data: torch.Tensor


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedTensor:
    """A tensor split or replicated over the positions of a mesh of
    distinct devices: the counterpart of a `jax.Array` under a
    `NamedSharding`.  ``shards`` holds one `Shard` per mesh position in
    row-major order (the order of JAX's ``addressable_shards``); a
    replicated dimension gives every position a full copy of its own."""

    shape: tuple[int, ...]
    dtype: torch.dtype
    sharding: NamedSharding
    shards: tuple[Shard, ...]

    @classmethod
    def from_tensor(cls, x: torch.Tensor, sharding: NamedSharding) -> "ShardedTensor":
        """Split ``x`` by mesh position and copy each piece to that
        position's device — also where a device repeats."""
        sharding = check_sharding(sharding)
        shards = tuple(
            Shard(dev, index, x[index].to(dev, copy=True,
                                          memory_format=torch.contiguous_format))
            for dev, index in zip(sharding.mesh.devices.reshape(-1).tolist(),
                                  sharding.shard_indices(x.shape)))
        return cls(tuple(x.shape), x.dtype, sharding, shards)

    def full(self, device) -> torch.Tensor:
        """The global tensor on ``device`` (the counterpart of
        ``np.asarray`` of a `jax.Array`), assembled from one shard per
        distinct index.  Raises if a shard is on ``meta``: it holds no
        data."""
        if any(s.device.type == "meta" for s in self.shards):
            raise RuntimeError("ShardedTensor.full: a shard is on the meta "
                               "device and holds no data")
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        done = set()
        for s in self.shards:
            key = tuple((sl.start, sl.stop) for sl in s.index)
            if key not in done:
                done.add(key)
                out[s.index] = s.data
        return out


def device_put(x: torch.Tensor, sharding: NamedSharding):
    """``x`` placed by ``sharding``, as ``jax.device_put(x, NamedSharding)``:
    on a mesh of one distinct device, a plain tensor on that device; on a
    mesh of distinct devices, a `ShardedTensor`.  A spec naming an axis the
    mesh lacks, or a dimension that does not divide over its axes, raises
    ValueError in either case."""
    sharding = check_sharding(sharding)
    sharding.shard_shape(x.shape)
    devices = set(sharding.mesh.devices.reshape(-1).tolist())
    if len(devices) == 1:
        return x.to(devices.pop())
    return ShardedTensor.from_tensor(x, sharding)


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
