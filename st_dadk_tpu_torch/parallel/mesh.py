"""Rank meshes and the placement of lanes on them (port of
`st_dadk_tpu/parallel/mesh.py`).

The framework's axes, over ranks (one process a card) instead of devices:
  - 'exp'  : experiment repeats or stacked grid configs, independent fits
             with no collective (the lane engine, `train/batch_engine.py`);
  - 'data' : data parallelism inside one fit (a gradient sum a step,
             `parallel/data_parallel.py`).

A `RankMesh` is a grid of ranks with named axes. Where a process group is
joined and the mesh spans it, `device_mesh()` gives the matching
`torch.distributed.device_mesh.DeviceMesh` and `axis_group(axis)` the
process group of this rank's row along an axis; a single process needs
neither. `lane_sharding` and `replicated` map a lane row to the ranks that
hold it.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch.distributed as dist


class RankMesh:
    """Ranks (or fake devices in tests) on named axes: `devices` is an
    object array whose shape is the axes' sizes."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{len(self.axis_names)} axis names for a "
                             f"{self.devices.ndim}-d grid")
        self._device_mesh = None

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def ranks(self) -> np.ndarray:
        """The grid of ranks (`process_index` of each device)."""
        return np.vectorize(lambda d: int(d.process_index),
                            otypes=[np.int64])(self.devices)

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def coords(self, rank: int) -> Dict[str, int]:
        """The mesh coordinates of `rank`."""
        where = np.argwhere(self.ranks == rank)
        if len(where) != 1:
            raise ValueError(f"rank {rank} is not on the mesh once")
        return dict(zip(self.axis_names, (int(i) for i in where[0])))

    def device_mesh(self, device_type: str):
        """The `DeviceMesh` of this grid (built once; needs a joined group
        of exactly these ranks)."""
        if self._device_mesh is None:
            from torch.distributed.device_mesh import DeviceMesh
            if not dist.is_initialized() \
                    or dist.get_world_size() != self.size:
                raise ValueError("a DeviceMesh needs a joined group of "
                                 f"{self.size} ranks")
            self._device_mesh = DeviceMesh(device_type, self.ranks.tolist(),
                                           mesh_dim_names=self.axis_names)
        return self._device_mesh

    def axis_group(self, axis: str, device_type: str = "cpu"):
        """This rank's process group along `axis`; None on a one-rank axis
        with no group joined (no collective is needed there)."""
        if not dist.is_initialized():
            if self.shape[axis] != 1:
                raise ValueError(f"axis {axis!r} spans {self.shape[axis]} "
                                 "ranks but no process group is joined")
            return None
        if self.devices.ndim == 1 and self.size == dist.get_world_size():
            return dist.group.WORLD
        return self.device_mesh(device_type).get_group(axis)


def make_mesh(axes: Optional[Dict[str, int]] = None,
              devices: Optional[Sequence] = None) -> RankMesh:
    """A mesh over `devices` (default: every rank of the group, in rank
    order), all on one 'exp' axis unless `axes` names sizes."""
    if devices is None:
        from st_dadk_tpu_torch.parallel.multihost import rank_devices
        devices = rank_devices()
    devices = list(devices)
    if axes is None:
        axes = {"exp": len(devices)}
    shape = tuple(axes.values())
    n = int(np.prod(shape))
    if n != len(devices):
        raise ValueError(f"mesh {axes} needs {n} ranks, have {len(devices)}")
    grid = np.empty(len(devices), dtype=object)
    grid[:] = devices
    return RankMesh(grid.reshape(shape), tuple(axes.keys()))


class LaneSharding:
    """Lane rows laid out contiguously over a mesh axis: row i of M lives
    on the ranks at coordinate i // (M / size) of `axis` (every rank of
    that coordinate, across the other axes)."""

    def __init__(self, mesh: RankMesh, axis: Optional[str]):
        self.mesh, self.axis = mesh, axis

    def ranks_of(self, row: int, M: int) -> list:
        if self.axis is None:
            return sorted(int(r) for r in self.mesh.ranks.ravel())
        size = self.mesh.shape[self.axis]
        if M % size:
            raise ValueError(f"M={M} lanes must divide over "
                             f"{self.axis}={size}")
        coord = row // (M // size)
        ax = self.mesh.axis_names.index(self.axis)
        return sorted(int(r) for r in np.take(self.mesh.ranks, coord,
                                              axis=ax).ravel())


def lane_sharding(mesh: RankMesh, axis: str = "exp") -> LaneSharding:
    """The leading (lane) axis split over `axis`."""
    return LaneSharding(mesh, axis)


def replicated(mesh: RankMesh) -> LaneSharding:
    """Every row on every rank."""
    return LaneSharding(mesh, None)
