"""Processes of a cluster on torch.distributed (port of
`st_dadk_tpu/parallel/multihost.py`).

One process a device: rank r drives one card (`local_device`), every rank
runs the same code, and the ranks join one default process group. The
JAX package's design rules carry over with ranks for devices:

  - 'exp' lanes are independent fits: each process trains the lanes it
    owns (`process_lane_slice`) with no collective, so the 'exp' axis is
    laid out across hosts (`hybrid_mesh`, `experiment_mesh_auto`);
  - 'data' and 'tp' carry a sum every step and are laid out within one
    host's ranks.

A rank is a `RankDevice` (its rank, its host's index, optional slice): the
layout functions take any objects with `id` and `process_index` (and
optionally `slice_index` or `host_index`), so they are tested with fake
devices. Every function degrades to the single-process behaviour when no
group was joined.

Backends: `nccl` for CUDA devices and `gloo` for the CPU, unless the caller
names one. NCCL refuses two ranks on one card; such a run (tests, a
one-card smoke run) names `gloo`, which takes CUDA tensors for
`all_reduce` and `broadcast`. Nothing falls back from one backend to the
other.
"""
from __future__ import annotations

import datetime
import os
import socket
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# seconds a group's init and every collective may wait for the other ranks
DEFAULT_TIMEOUT = 60.0

_STATE: Dict[str, Any] = {"device": None, "backend": None}


def _address(addr: str) -> str:
    """'host:port' (JAX's coordinator form) or a URL -> an init_method."""
    return addr if "://" in addr else f"tcp://{addr}"


def _local_card() -> torch.device:
    """The rank's card: cuda:(LOCAL_RANK mod the cards this process sees),
    so that several ranks may share one card."""
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % max(1, torch.cuda.device_count()))


def maybe_initialize_distributed(coordinator_address: Optional[str] = None,
                                 num_processes: Optional[int] = None,
                                 process_id: Optional[int] = None,
                                 backend: Optional[str] = None,
                                 device: Optional[torch.device | str] = None,
                                 timeout: float = DEFAULT_TIMEOUT) -> bool:
    """Join the default process group when this process is one of a
    cluster; True when a group is (already) joined.

      - explicit arguments win (`coordinator_address` 'host:port' or a
        URL, `num_processes`, `process_id`); a failure to join raises;
      - else torchrun's environment (MASTER_ADDR, WORLD_SIZE, RANK and
        LOCAL_RANK) through `env://`;
      - else JAX's (JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES,
        JAX_PROCESS_ID);
      - else this is a single process: a no-op that returns False, as in
        JAX (`:35-87`).

    `device` is the rank's device (default: the card of LOCAL_RANK,
    `_local_card`); `backend` defaults to nccl on a card and gloo on the
    CPU. A CUDA device becomes the process's current device, where the
    kernels launch."""
    if dist.is_initialized():
        return True
    env = os.environ
    kwargs: Dict[str, Any] = {}
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("an explicit coordinator_address needs "
                             "num_processes and process_id")
        kwargs = dict(init_method=_address(coordinator_address),
                      world_size=int(num_processes), rank=int(process_id))
    elif all(env.get(k) for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK",
                                  "LOCAL_RANK")):
        kwargs = dict(init_method="env://")
    elif all(env.get(k) for k in ("JAX_COORDINATOR_ADDRESS",
                                  "JAX_NUM_PROCESSES", "JAX_PROCESS_ID")):
        kwargs = dict(init_method=_address(env["JAX_COORDINATOR_ADDRESS"]),
                      world_size=int(env["JAX_NUM_PROCESSES"]),
                      rank=int(env["JAX_PROCESS_ID"]))
    else:
        return False
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and dev.index is None:
        dev = _local_card()
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, timeout=datetime.timedelta(
        seconds=timeout), **kwargs)
    _STATE.update(device=dev, backend=backend)
    return True


def local_device() -> Optional[torch.device]:
    """The rank's device of the joined group, or None with no group."""
    return _STATE["device"] if dist.is_initialized() else None


def collective_device() -> torch.device:
    """Where a tensor must live for the group's collectives: the rank's
    card under nccl, the CPU otherwise."""
    if dist.get_backend() == "nccl":
        return _STATE["device"] or torch.device("cuda",
                                                torch.cuda.current_device())
    return torch.device("cpu")


def shutdown() -> None:
    """Leave the default group (no-op without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _STATE.update(device=None, backend=None)


@dataclass(frozen=True)
class RankDevice:
    """One rank as a mesh coordinate: `id` and `process_index` are its
    rank, `host_index` its host's place among the group's hosts."""
    id: int
    process_index: int
    host_index: int = 0

    def __repr__(self) -> str:
        return f"rank{self.id}"


def rank_devices() -> List[RankDevice]:
    """Every rank of the group with its host (one all_gather of the host
    names), or the one process."""
    pc, _ = process_info()
    if pc == 1:
        return [RankDevice(0, 0, 0)]
    names: List[Optional[str]] = [None] * pc
    dist.all_gather_object(names, socket.gethostname())
    hosts = {h: i for i, h in enumerate(dict.fromkeys(names))}
    return [RankDevice(r, r, hosts[h]) for r, h in enumerate(names)]


def _group_key(d) -> int:
    """DCN group of a device: its slice where it has one, else its host
    (`host_index` for a rank, `process_index` for a host's devices)."""
    s = getattr(d, "slice_index", None)
    if s is not None:
        return int(s)
    h = getattr(d, "host_index", None)
    if h is not None:
        return int(h)
    return int(getattr(d, "process_index", 0))


def group_devices_by_dcn(devices: Optional[Sequence] = None) -> List[List]:
    """Partition devices (default: the group's ranks) into DCN groups, each
    sorted by id, the groups by key, so every process computes one global
    order."""
    devices = list(devices if devices is not None else rank_devices())
    groups: Dict[int, List] = {}
    for d in devices:
        groups.setdefault(_group_key(d), []).append(d)
    return [sorted(groups[k], key=lambda d: int(getattr(d, "id", 0)))
            for k in sorted(groups)]


def hybrid_mesh(axes: Dict[str, int], dcn_axis: str = "exp",
                devices: Optional[Sequence] = None):
    """A rank mesh whose `dcn_axis` strides across hosts and whose other
    axes stay within one host (JAX `hybrid_mesh`): `dcn_axis`'s size must
    be a multiple of the number of hosts, the rest must fit in one host's
    ranks. With one host this is `make_mesh` exactly."""
    from st_dadk_tpu_torch.parallel.mesh import RankMesh
    groups = group_devices_by_dcn(devices)
    per_group = len(groups[0])
    if any(len(g) != per_group for g in groups):
        raise ValueError("DCN groups are unequal; cannot build a hybrid mesh")
    if dcn_axis not in axes:
        raise ValueError(f"dcn_axis {dcn_axis!r} not in axes {axes}")
    names = tuple(axes.keys())
    shape = tuple(axes.values())
    total = int(np.prod(shape))
    if total != len(groups) * per_group:
        raise ValueError(f"mesh {axes} needs {total} ranks, have "
                         f"{len(groups) * per_group}")
    return RankMesh(_hybrid_grid(names, shape, names.index(dcn_axis),
                                 groups), names)


def _hybrid_grid(names, shape, dcn_pos: int, groups: List[List]) -> np.ndarray:
    """The device grid of `hybrid_mesh`: the dcn axis advances through the
    groups, the other axes within a group, whose devices are taken in
    (lane, offset) order."""
    n_groups = len(groups)
    per_group = len(groups[0])
    dcn_size = shape[dcn_pos]
    total = int(np.prod(shape))
    if dcn_size % n_groups != 0:
        raise ValueError(f"{names[dcn_pos]}={dcn_size} must be a multiple of "
                         f"the {n_groups} DCN group(s)")
    ici_total = total // dcn_size
    lanes_per_group = dcn_size // n_groups
    if lanes_per_group * ici_total != per_group:
        raise ValueError("ICI axes do not fit inside one DCN group")
    grid = np.empty(shape, dtype=object)
    cursors = np.zeros(n_groups, np.int64)
    for idx in np.ndindex(*shape):
        g = idx[dcn_pos] // lanes_per_group
        grid[idx] = groups[g][int(cursors[g])]
        cursors[g] += 1
    return grid


def experiment_mesh_auto(axis: str = "exp",
                         devices: Optional[Sequence] = None):
    """All ranks on one `axis`, grouped by host so that each host holds a
    contiguous block of lanes."""
    from st_dadk_tpu_torch.parallel.mesh import RankMesh
    flat = [d for g in group_devices_by_dcn(devices) for d in g]
    arr = np.empty(len(flat), dtype=object)
    arr[:] = flat
    return RankMesh(arr, (axis,))


def process_lane_slice(M: int, mesh, axis: str = "exp",
                       process_index: Optional[int] = None,
                       process_count: Optional[int] = None) -> slice:
    """The lanes [lo, hi) of a batch of M that this process sets up, trains
    and writes: its share of the mesh's `axis`, lanes laid out contiguously
    over it. One process: slice(0, M). `process_index` / `process_count`
    default to the group's (overridable for layout tests)."""
    if process_count is None or process_index is None:
        pc, pid = process_info()
        process_count = pc if process_count is None else process_count
        process_index = pid if process_index is None else process_index
    if process_count == 1:
        return slice(0, M)
    axis_size = mesh.shape[axis]
    if M % axis_size != 0:
        raise ValueError(f"M={M} lanes must divide over {axis}={axis_size} "
                         "for multi-process lanes (pad the batch)")
    ax = list(mesh.axis_names).index(axis)
    local = {idx[ax] for idx in np.ndindex(*mesh.devices.shape)
             if mesh.devices[idx].process_index == process_index}
    if not local:
        return slice(0, 0)
    lo, hi = min(local), max(local) + 1
    if len(local) != hi - lo:
        raise ValueError("this process's lane coordinates are not contiguous;"
                         " use hybrid_mesh/experiment_mesh_auto layouts")
    per = M // axis_size
    return slice(lo * per, hi * per)


def process_info() -> tuple:
    """(process_count, process_index): the group's world size and rank,
    (1, 0) without a group; the one seam the gating reads, so tests can
    patch a fake cluster onto one process."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def is_primary() -> bool:
    """True on the process that aggregates and writes summaries."""
    return process_info()[1] == 0


def shared_timestamp() -> datetime.datetime:
    """A datetime equal on every process: the primary's clock, broadcast.
    Default output directories come from it, so that processes crossing a
    second boundary still write into one tree. One process: now()."""
    ts = time.time()
    if process_info()[0] > 1:
        t = torch.tensor([ts], dtype=torch.float64,
                         device=collective_device())
        dist.broadcast(t, src=0)
        ts = float(t.item())
    return datetime.datetime.fromtimestamp(ts)


def sync_processes(name: str = "st_dadk_barrier") -> None:
    """A barrier over the group (no-op for one process): between the
    processes' own writes and the primary's aggregation. `name` labels the
    barrier in errors."""
    if process_info()[0] > 1:
        try:
            if dist.get_backend() == "nccl":
                dist.barrier(device_ids=[collective_device().index])
            else:
                dist.barrier()
        except RuntimeError as e:
            raise RuntimeError(f"barrier {name!r} failed: {e}") from e


def fetch_lane_rows(x, sl: slice, owned: Optional[slice] = None
                    ) -> np.ndarray:
    """Rows `sl` (global lane indices) of a lane-major array or tensor `x`
    that holds the global rows `owned` (default: all of x, rows 0..len).
    Each process holds only its own lanes, so this is a slice of them; a
    row outside `owned` raises."""
    owned = owned if owned is not None else slice(0, int(x.shape[0]))
    if sl.stop <= sl.start:
        part = x[0:0]    # a process may own no real lane of a batch
    elif sl.start < owned.start or sl.stop > owned.stop:
        raise ValueError(
            f"lane rows {sl} are not held by process {process_info()[1]} "
            f"(it holds {owned}); request only process_lane_slice rows")
    else:
        part = x[sl.start - owned.start:sl.stop - owned.start]
    if isinstance(part, torch.Tensor):
        return part.detach().cpu().numpy()
    return np.asarray(part)


def fetch_lane_tree(tree, sl: slice, owned: Optional[slice] = None):
    """`fetch_lane_rows` over every leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: fetch_lane_tree(v, sl, owned) for k, v in tree.items()}
    return fetch_lane_rows(tree, sl, owned)


def shard_lanes_multihost(tree, mesh, axis: str = "exp"):
    """This process's rows (`process_lane_slice`) of every leaf of a
    globally shaped lane-major tree: what it sets up and trains. One
    process: the tree itself."""
    if isinstance(tree, dict):
        return {k: shard_lanes_multihost(v, mesh, axis)
                for k, v in tree.items()}
    return tree[process_lane_slice(int(tree.shape[0]), mesh, axis)]
