"""Device meshes over explicit device lists: the port's counterpart of the
JAX package's ``launch/mesh.py``.

A ``Mesh`` is an n-d grid of ``torch.device`` with named axes (JAX's
shapes and names).  Entries may repeat: a list of one card's device
repeated n times is n *virtual* chips, as ``XLA_FLAGS=
--xla_force_host_platform_device_count`` makes n host devices for the
JAX package's tests.  ``chips`` optionally names each entry's chip (any
hashable ids, one per device), so two meshes over the same repeated
device still differ when they cover different chips; it takes part in
equality, as the device set does in JAX's.
"""
from __future__ import annotations

import numpy as np
import torch


class Mesh:
    def __init__(self, devices, axis_names: tuple[str, ...], chips=None):
        arr = np.asarray(devices, dtype=object)
        if arr.ndim != len(axis_names):
            raise ValueError(f"a {arr.ndim}-d device grid for axes "
                             f"{axis_names}")
        grid = np.empty(arr.shape, dtype=object)
        for i, d in enumerate(arr.flat):
            grid.flat[i] = torch.device(d)
        self.devices = grid
        self.axis_names = tuple(axis_names)
        if chips is not None:
            chips = tuple(chips)
            if len(chips) != grid.size:
                raise ValueError(f"{len(chips)} chip ids for "
                                 f"{grid.size} devices")
        self.chips = chips

    @property
    def shape(self) -> dict:
        """Axis name -> size, in axis order (JAX's ``Mesh.shape``)."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def _key(self):
        return (self.axis_names, self.devices.shape,
                tuple(str(d) for d in self.devices.flat), self.chips)

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def axis_size(self, axes) -> int:
        """The size of ``axes``: one axis name, a tuple of them (their
        product, as a spec tuple shards over), or None (1)."""
        if axes is None:
            return 1
        if isinstance(axes, str):
            axes = (axes,)
        return int(np.prod([self.shape.get(a, 1) for a in axes]))

    def device(self, *coord: int) -> torch.device:
        """The device at a full coordinate, one index per axis."""
        return self.devices[coord]

    def chip(self, *coord: int):
        """The chip id at a full coordinate (None without ``chips``)."""
        if self.chips is None:
            return None
        return self.chips[int(np.ravel_multi_index(coord,
                                                   self.devices.shape))]

    @property
    def batch_axes(self) -> tuple[str, ...]:
        """Every axis but ``model``, in axis order: ("data",) or ("pod",
        "data"), the axes a plan's ``batch`` rule spans."""
        return tuple(a for a in self.axis_names if a != "model")

    @property
    def n_batch(self) -> int:
        """The flat size of the batch axes (pod x data)."""
        return self.axis_size(self.batch_axes)

    @property
    def tp(self) -> int:
        return self.axis_size("model")

    def batch_coord(self, b: int) -> dict:
        """Axis name -> index of flat batch index ``b`` (first axis
        major, as a spec tuple ("pod", "data") flattens)."""
        sizes = [self.shape[a] for a in self.batch_axes]
        return dict(zip(self.batch_axes, np.unravel_index(b, sizes)))

    def at(self, b: int, m: int) -> torch.device:
        """The device at flat batch index ``b`` and model index ``m``."""
        c = self.batch_coord(b)
        return self.devices[tuple(m if a == "model" else int(c[a])
                                  for a in self.axis_names)]

    def group(self, b: int) -> list[torch.device]:
        """The model axis's devices at flat batch index ``b``: one data
        group's row of the grid."""
        return [self.at(b, m) for m in range(self.tp)]

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.devices.flat]}"
                + (f", chips={list(self.chips)}" if self.chips else "")
                + ")")


class ReplicaMesh(Mesh):
    """One serving replica's (pp, tp) grid, axes ("pipe", "model")."""

    def __init__(self, devices, chips=None):
        super().__init__(devices, ("pipe", "model"), chips)

    @property
    def pp(self) -> int:
        return self.devices.shape[0]

    @property
    def first(self) -> torch.device:
        """The (0, 0) device: where the replica's tables and reductions
        live."""
        return self.devices[0, 0]


def make_production_mesh(devices, *, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    devices = list(devices)
    if len(devices) != int(np.prod(shape)):
        raise ValueError(f"production mesh {shape} needs "
                         f"{int(np.prod(shape))} devices, got {len(devices)}")
    return Mesh(np.asarray(devices, dtype=object).reshape(shape), axes)


def make_small_mesh(devices, model: int = 2) -> Mesh:
    """Test mesh of shape (len(devices) // model, model)."""
    devices = list(devices)
    return Mesh(np.asarray(devices, dtype=object).reshape(
        len(devices) // model, model), ("data", "model"))


def make_replica_mesh(devices, tp: int, pp: int = 1,
                      chips=None) -> ReplicaMesh:
    """Mesh for ONE serving replica: shape (pp, tp), axes ("pipe", "model").

    ``devices`` is this replica's slice of the device set (len == tp * pp),
    ``chips`` optionally the ids of its chips; the cluster runtime carves
    its chips into per-replica slices so heterogeneous deployments place
    each replica on its own sub-mesh.  Tensor parallelism shards heads /
    d_ff / vocab over ``model`` (the serving ``ShardingPlan`` rules);
    pipeline parallelism shards the layer-stacked parameter (and paged
    pool) leading axis over ``pipe``.
    """
    devices = list(devices)
    if len(devices) != tp * pp:
        raise ValueError(
            f"replica mesh needs tp*pp={tp * pp} devices, got {len(devices)}")
    return ReplicaMesh(np.asarray(devices, dtype=object).reshape(pp, tp),
                       chips)
