"""The lane optimizer: per-lane gradient clipping, AdamW and EMA over every
leaf (parameter tensor) of a lane fit, one launch a stage.

Three functions each run hand-written CUDA kernels
(`csrc/lane_optimizer.cu`) on CUDA tensors:

  - `clip_lanes_`   `lane_clip_sumsq` + `lane_clip_scale` (two launches for
                    every clip group together)
  - `adamw_lanes_`  `lane_adamw` (the lanes' step counts in the same launch)
  - `ema_lanes_`    `lane_ema`

They replace no TPU kernel: the JAX package leaves its optimizer to XLA,
which fuses it; the port's eager form launched some 26 kernels a leaf. On
CPU tensors each function runs its plain version (`plain_clip_lanes_`,
`plain_adamw_lanes_`, `plain_ema_lanes_`: the eager form of
`train/optimizer.py`); on CUDA tensors it launches or raises.

A leaf is (M, ...) contiguous float32, lane m's n elements one behind the
other. A launch takes a table of its leaves (int64 rows of TABLE_COLS: the
kernel's tensors' addresses, n, the leaf's first block, its group, float4
access) that the C entry point copies into the kernel's parameters, so a
step copies nothing to the device and reads nothing from it. Blocks map to
(leaf, lane, chunk of CHUNK elements): x walks the leaves' chunks, y the
lanes. `plan_launches` lays the chunks out, at most MAX_LEAVES leaves a
launch; `leaf_of` and `block_elements` mirror how a kernel finds its leaf
and the elements it visits, for the tests.

The clip's first launch writes one partial sum of g * g a (lane, block) to
a workspace (M, blocks a lane), the leaves of each clip group one after the
other; the second sums each lane's partials of a group in a fixed order and
scales. No atomics: two runs are bitwise equal.

Each launch function counts its calls by shape (`_LAUNCHES`, an
`_launch.LaunchCounter`): one a device launch, the shape (lanes, leaves,
elements a lane); `launch_counts()` and `launch_shapes()` read it.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from st_dadk_tpu_torch.ops._build import load_library
from st_dadk_tpu_torch.ops._launch import (LaunchCounter, check, on_cpu,
                                           raise_on, stream)

# the constants of csrc/lane_optimizer.cu
THREADS = 256
CHUNK = 4096               # elements a block, of one leaf and one lane
MAX_LEAVES = 64            # leaves a launch
MAX_CLIP_GROUPS = 4
MAX_LANES = 65535          # the grid's y dimension
TABLE_COLS = 8             # 4 addresses, n, first block, group, float4

_LIB_NAME = "lane_optimizer"
_P, _I = ctypes.c_void_p, ctypes.c_int
_KERNELS = None   # (clip sumsq, clip scale, adamw, ema) C entry points
# (pointer, int) argument counts of each entry point before its stream
_SIGNATURES = (("st_lane_clip_sumsq", 2, 4),
               ("st_lane_clip_scale", 4, 4),
               ("st_lane_adamw", 6, 6),
               ("st_lane_ema", 4, 5))


def _kernels():
    """The library's entry points, built, loaded and typed at the first
    launch on a CUDA tensor."""
    global _KERNELS
    if _KERNELS is None:
        lib = load_library(_LIB_NAME)
        fns = []
        for name, n_ptr, n_int in _SIGNATURES:
            fn = getattr(lib, name)
            fn.argtypes = [_P] * n_ptr + [_I] * n_int + [_P]
            fn.restype = ctypes.c_int
            fns.append(fn)
        _KERNELS = tuple(fns)
    return _KERNELS


# ---------------------------------------------------------------------------
# Plain versions (CPU tensors)
# ---------------------------------------------------------------------------

def _per_lane(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(M,) as (M, 1, ...) broadcasting against `like` (M, ...)."""
    return x.reshape(x.shape[0], *([1] * (like.dim() - 1)))


@torch.no_grad()
def plain_clip_lanes_(grads: Sequence[torch.Tensor], max_norm: float
                      ) -> None:
    """In place: scale each lane's group by its own global L2 norm."""
    total = torch.sqrt(sum(torch.sum(g * g, dim=tuple(range(1, g.dim())))
                           for g in grads))                       # (M,)
    scale = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    for g in grads:
        g.mul_(_per_lane(scale, g))


@torch.no_grad()
def plain_adamw_lanes_(groups: Sequence[Sequence[Tuple[torch.Tensor, ...]]],
                       lrs: torch.Tensor, executes: torch.Tensor,
                       step_count: torch.Tensor, b1: float, b2: float,
                       eps: float, weight_decay: float) -> torch.Tensor:
    """`adamw_lanes_` in eager PyTorch; step_count is updated in place."""
    t = (step_count + 1).to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.full_like(t, b1), t)              # (M,)
    bc2 = 1.0 - torch.pow(torch.full_like(t, b2), t)
    for j, leaves in enumerate(groups):
        lr = lrs[:, j]
        decay = 1.0 - lr * weight_decay
        for p, m, v in leaves:
            grad = p.grad
            ex = _per_lane(executes, p)
            m_new = torch.add(m * b1, grad, alpha=1 - b1)
            v_new = torch.addcmul(v * b2, grad, grad, value=1 - b2)
            upd = ((m_new / _per_lane(bc1, p))
                   / (torch.sqrt(v_new / _per_lane(bc2, p)) + eps))
            p_new = p * _per_lane(decay, p) - _per_lane(lr, p) * upd
            # where, not a product with the mask: a lane that does not
            # execute may hold a non-finite gradient
            m.copy_(torch.where(ex, m_new, m))
            v.copy_(torch.where(ex, v_new, v))
            p.copy_(torch.where(ex, p_new, p))
    step_count += executes.to(torch.int32)
    return step_count


@torch.no_grad()
def plain_ema_lanes_(ema: Sequence[torch.Tensor],
                     params: Sequence[torch.Tensor], decay: torch.Tensor,
                     one_minus_decay: torch.Tensor,
                     executes: torch.Tensor) -> None:
    """`ema_lanes_` in eager PyTorch."""
    for s, p in zip(ema, params):
        new = s * _per_lane(decay, s) + p * _per_lane(one_minus_decay, s)
        s.copy_(torch.where(_per_lane(executes, s), new, s))


# ---------------------------------------------------------------------------
# The leaf table and its mirror
# ---------------------------------------------------------------------------

def blocks_of(n: int) -> int:
    """Blocks (chunks) of a leaf of n elements a lane."""
    return -(-n // CHUNK)


def plan_launches(sizes: Sequence[int]
                  ) -> List[Tuple[int, int, List[int], int]]:
    """The launches over leaves of `sizes` elements a lane (each >= 1), in
    order, at most MAX_LEAVES leaves each: (first leaf, end leaf, each
    leaf's first block in the launch, the launch's first column in a lane's
    row of blocks, which the clip's partials follow)."""
    out, offset = [], 0
    for a in range(0, len(sizes), MAX_LEAVES):
        b = min(a + MAX_LEAVES, len(sizes))
        firsts, x = [], 0
        for n in sizes[a:b]:
            firsts.append(x)
            x += blocks_of(n)
        out.append((a, b, firsts, offset))
        offset += x
    return out


def leaf_of(firsts: Sequence[int], x: int) -> int:
    """The leaf of block x: the last l with firsts[l] <= x (the kernels'
    binary search)."""
    lo, hi = 0, len(firsts) - 1
    while lo < hi:
        mid = (lo + hi + 1) >> 1
        if firsts[mid] <= x:
            lo = mid
        else:
            hi = mid - 1
    return lo


def block_elements(n: int, chunk: int, vec: bool) -> np.ndarray:
    """The elements of one lane that block `chunk` of a leaf of n elements a
    lane visits, as the kernels' `walk` steps: a thread's float4s (vec) or
    floats CHUNK / 4 / THREADS or CHUNK / THREADS rounds apart."""
    t = np.arange(THREADS)[None, :]
    if vec:
        q = chunk * (CHUNK // 4) + t + THREADS * np.arange(
            CHUNK // 4 // THREADS)[:, None]
        q = q[q < n // 4]
        return (4 * q[:, None] + np.arange(4)[None, :]).ravel()
    e = chunk * CHUNK + t + THREADS * np.arange(CHUNK // THREADS)[:, None]
    return e[e < n]


def leaf_tables(leaves: Sequence[Sequence[torch.Tensor]],
                sizes: Sequence[int], groups: Sequence[int]
                ) -> List[Tuple[np.ndarray, int]]:
    """Each launch's table (leaves x TABLE_COLS int64) and its first column
    in a lane's row of blocks: leaf l's tensors' addresses, sizes[l], its
    first block, groups[l], and float4 access where sizes[l] % 4 == 0 and
    every address is 16-byte aligned."""
    out = []
    for a, b, firsts, offset in plan_launches(sizes):
        ptrs = np.asarray([[t.data_ptr() for t in leaves[l]]
                           for l in range(a, b)], dtype=np.int64)
        n = np.asarray(sizes[a:b], dtype=np.int64)
        table = np.zeros((b - a, TABLE_COLS), dtype=np.int64)
        table[:, :ptrs.shape[1]] = ptrs
        table[:, 4], table[:, 5], table[:, 6] = n, firsts, groups[a:b]
        table[:, 7] = (n % 4 == 0) & (ptrs % 16 == 0).all(axis=1)
        out.append((table, offset))
    return out


# ---------------------------------------------------------------------------
# Checks
# ---------------------------------------------------------------------------

def _lane_leaves(what: str, leaves: Sequence[Sequence[torch.Tensor]],
                 names: Sequence[str]) -> Tuple[int, List[int]]:
    """(M, elements a lane of each leaf) after checking that each leaf's
    tensors are float32, contiguous, of one shape (M, ...), M the same for
    every leaf and within the grid, and a lane's elements at least one and
    within int32."""
    lanes = leaves[0][0].shape[0] if leaves[0][0].dim() else 0
    if not 1 <= lanes <= MAX_LANES:
        raise ValueError(f"{what}: {lanes} lanes; 1 to {MAX_LANES} launch")
    sizes = []
    for ts in leaves:
        shape = ts[0].shape
        if not shape or shape[0] != lanes:
            raise ValueError(f"{what}: a leaf of shape {tuple(shape)} has no "
                             f"lane axis of {lanes}")
        if not all(t.dtype == torch.float32 and t.shape == shape
                   and t.is_contiguous() for t in ts):
            for name, t in zip(names, ts):
                check(f"{what} {name}", t, tuple(shape))
        n = ts[0].numel() // lanes
        if not 1 <= n < 2 ** 31 - CHUNK:
            raise ValueError(f"{what}: {n} elements a lane; 1 to "
                             f"{2 ** 31 - CHUNK - 1} launch")
        sizes.append(n)
    return lanes, sizes


def _lane_vector(what: str, t: torch.Tensor, lanes: int,
                 dtype: torch.dtype) -> None:
    """Refuse anything but a per-lane (M,) tensor of `dtype` (any stride:
    the kernels take it)."""
    if t.dtype != dtype or tuple(t.shape) != (lanes,):
        raise ValueError(f"{what}: expected {dtype} ({lanes},), got "
                         f"{t.dtype} {tuple(t.shape)}")


# ---------------------------------------------------------------------------
# Launches, each counted
# ---------------------------------------------------------------------------

def _count(fn, lanes: int, table: np.ndarray) -> None:
    _LAUNCHES.add(fn, (lanes, table.shape[0], int(table[:, 4].sum())))


def lane_clip_sumsq(table, offset, partials, lanes, st) -> None:
    """The clip's partial sums of g * g of the table's leaves into
    partials (M, blocks a lane) from column `offset`."""
    rc = _kernels()[0](table.ctypes.data, partials.data_ptr(),
                       table.shape[0], lanes, partials.shape[1], offset, st)
    raise_on(rc, "lane_clip_sumsq")
    _count(lane_clip_sumsq, lanes, table)


def lane_clip_scale(table, max_norms, group_first, partials, lanes,
                    st) -> None:
    """Each lane's gradients of the table's leaves scaled by its clip
    group's norm, summed from the partials."""
    rc = _kernels()[1](table.ctypes.data, max_norms.ctypes.data,
                       group_first.ctypes.data, partials.data_ptr(),
                       table.shape[0], lanes, len(max_norms),
                       partials.shape[1], st)
    raise_on(rc, "lane_clip_scale")
    _count(lane_clip_scale, lanes, table)


def lane_adamw(table, hyper, lrs, executes, count_in, count_out, lanes,
               st) -> None:
    """AdamW of the table's leaves; count_out (or None) gets the step
    counts after the step."""
    rc = _kernels()[2](table.ctypes.data, hyper.ctypes.data, lrs.data_ptr(),
                       executes.data_ptr(), count_in.data_ptr(),
                       None if count_out is None else count_out.data_ptr(),
                       table.shape[0], lanes, lrs.shape[1], lrs.stride(0),
                       lrs.stride(1), executes.stride(0), st)
    raise_on(rc, "lane_adamw")
    _count(lane_adamw, lanes, table)


def lane_ema(table, decay, one_minus_decay, executes, lanes, st) -> None:
    """The EMA of the table's (shadow, param) leaves."""
    rc = _kernels()[3](table.ctypes.data, decay.data_ptr(),
                       one_minus_decay.data_ptr(), executes.data_ptr(),
                       table.shape[0], lanes, decay.stride(0),
                       one_minus_decay.stride(0), executes.stride(0), st)
    raise_on(rc, "lane_ema")
    _count(lane_ema, lanes, table)


# ---------------------------------------------------------------------------
# The three stages
# ---------------------------------------------------------------------------

def clip_plan(groups: Sequence[Tuple[List[torch.Tensor], float]]
              ) -> Tuple[int, List[Tuple[np.ndarray, int]], np.ndarray,
                         np.ndarray]:
    """The launches of `clip_lanes_` over non-empty groups, after its
    checks: (M, each launch's table and first column, each clip group's
    first column in a lane's row of partials and the end, the groups' max
    norms). The leaves follow group by group, so a group's partials are one
    run of columns."""
    if len(groups) > MAX_CLIP_GROUPS:
        raise ValueError(f"lane clip: {len(groups)} groups; at most "
                         f"{MAX_CLIP_GROUPS} launch")
    grads = [(g,) for gs, _ in groups for g in gs]
    lanes, sizes = _lane_leaves("lane clip", grads, ("g",))
    clip_of = [c for c, (gs, _) in enumerate(groups) for _ in gs]
    group_first = np.zeros(len(groups) + 1, dtype=np.int32)
    for n, c in zip(sizes, clip_of):
        group_first[c + 1:] += blocks_of(n)
    return (lanes, leaf_tables(grads, sizes, clip_of), group_first,
            np.asarray([mx for _, mx in groups], dtype=np.float32))


def clip_lanes_(groups: Sequence[Tuple[Sequence[torch.Tensor], float]]
                ) -> None:
    """In place: each lane's gradients of each group scaled by that lane's
    global L2 norm of the group, `max_norm` each group (torch's
    clip_grad_norm_ a lane, 1e-6 stabiliser); every group in the same two
    launches."""
    groups = [(list(g), float(mx)) for g, mx in groups if len(g)]
    if not groups:
        return
    grads = [g for gs, _ in groups for g in gs]
    if on_cpu("lane clip", *grads):
        for gs, mx in groups:
            plain_clip_lanes_(gs, mx)
        return
    lanes, tables, group_first, max_norms = clip_plan(groups)
    dev = grads[0].device
    partials = torch.empty((lanes, int(group_first[-1])),
                           dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        st = stream(grads[0])
        for table, offset in tables:
            lane_clip_sumsq(table, offset, partials, lanes, st)
        for table, _ in tables:
            lane_clip_scale(table, max_norms, group_first, partials, lanes,
                            st)


def adamw_lanes_(groups: Sequence[Sequence[Tuple[torch.Tensor, ...]]],
                 lrs: torch.Tensor, executes: torch.Tensor,
                 step_count: torch.Tensor, b1: float, b2: float, eps: float,
                 weight_decay: float) -> torch.Tensor:
    """One AdamW step of every (param, m, v) of `groups` from the param's
    `.grad`, group j at LR column j of lrs (M, n_groups) float32, where
    executes (M,) bool; returns the step counts (M,) int32 after it (on the
    CPU step_count itself, updated in place; on the card a new tensor,
    written by the launch that reads step_count)."""
    leaves = [(p, p.grad, m, v) for ps in groups for p, m, v in ps]
    if any(g is None for _, g, _, _ in leaves):
        raise ValueError("lane AdamW: a parameter has no gradient")
    tensors = [t for leaf in leaves for t in leaf]
    if on_cpu("lane AdamW", *tensors, lrs, executes, step_count):
        return plain_adamw_lanes_(groups, lrs, executes, step_count, b1, b2,
                                  eps, weight_decay)
    lanes, sizes = _lane_leaves("lane AdamW", leaves, ("p", "grad", "m", "v"))
    if (lrs.dtype != torch.float32 or lrs.dim() != 2
            or lrs.shape[0] != lanes or lrs.shape[1] < len(groups)):
        raise ValueError(f"lane AdamW: lrs must be float32 ({lanes}, >= "
                         f"{len(groups)}), got {lrs.dtype} "
                         f"{tuple(lrs.shape)}")
    _lane_vector("lane AdamW executes", executes, lanes, torch.bool)
    _lane_vector("lane AdamW step_count", step_count, lanes, torch.int32)
    if not step_count.is_contiguous():
        raise ValueError("lane AdamW: step_count must be contiguous")
    col = [j for j, ps in enumerate(groups) for _ in ps]
    hyper = np.asarray([b1, 1 - b1, b2, 1 - b2, eps, weight_decay],
                       dtype=np.float32)
    count = torch.empty_like(step_count)
    with torch.cuda.device(step_count.device):
        st = stream(step_count)
        for i, (table, _) in enumerate(leaf_tables(leaves, sizes, col)):
            lane_adamw(table, hyper, lrs, executes, step_count,
                       count if i == 0 else None, lanes, st)
    return count


def ema_lanes_(ema: Sequence[torch.Tensor], params: Sequence[torch.Tensor],
               decay: torch.Tensor, one_minus_decay: torch.Tensor,
               executes: torch.Tensor) -> None:
    """In place, where a lane executes: shadow = decay * shadow +
    (1 - decay) * param, with per-lane decay and one_minus_decay (M,)."""
    leaves = list(zip(ema, params))
    if not leaves:
        return
    tensors = [t for leaf in leaves for t in leaf]
    if on_cpu("lane EMA", *tensors, decay, one_minus_decay, executes):
        plain_ema_lanes_(ema, params, decay, one_minus_decay, executes)
        return
    lanes, sizes = _lane_leaves("lane EMA", leaves, ("shadow", "param"))
    _lane_vector("lane EMA decay", decay, lanes, torch.float32)
    _lane_vector("lane EMA one_minus_decay", one_minus_decay, lanes,
                 torch.float32)
    _lane_vector("lane EMA executes", executes, lanes, torch.bool)
    with torch.cuda.device(decay.device):
        st = stream(decay)
        for table, _ in leaf_tables(leaves, sizes, [0] * len(sizes)):
            lane_ema(table, decay, one_minus_decay, executes, lanes, st)


_LAUNCHES = LaunchCounter((lane_clip_sumsq, lane_clip_scale, lane_adamw,
                           lane_ema))


def reset_launch_counts() -> None:
    _LAUNCHES.reset()


def launch_counts() -> Dict[str, int]:
    return _LAUNCHES.counts()


def launch_shapes() -> Dict[str, List[Tuple]]:
    """Each launch's distinct shapes since the last reset, as (lanes,
    leaves, elements a lane)."""
    return _LAUNCHES.shapes()
