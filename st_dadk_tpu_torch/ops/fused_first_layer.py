"""Fused basis first layer h = phi(coords; centers, bw) @ W_s and its gradients.

Port of `st_dadk_tpu/ops/pallas_fused.py`. Four wrappers each run
hand-written CUDA kernels (`csrc/fused_first_layer.cu`) on a CUDA tensor:

  - `fused_first_layer_fwd`          <- `_fused_kernel`   (pallas_fused.py:48)
  - `fused_first_layer_bwd_w`        <- `_bwd_w_kernel`   (pallas_fused.py:129)
  - `fused_first_layer_bwd_points`   <- `_bwd_pts_kernel` (pallas_fused.py:147)
  - `fused_first_layer_bwd_centers`  <- `_bwd_ctr_kernel` (pallas_fused.py:170)

On CPU tensors each wrapper computes its plain PyTorch version instead
(`plain_fwd`, `plain_bwd_w`, `plain_bwd_points`, `plain_bwd_centers`); on a
CUDA tensor it launches its kernel or raises. `fused_spatial_first_layer` is
the differentiable entry point (the custom VJP at pallas_fused.py:195-318 as
an `autograd.Function`); the bandwidth -> inv_bw transform stays in torch so
log-bandwidth gradients flow through autograd.

The forward kernel owns (BN points x BH hidden) output tiles and builds each
point tile's phi once for its BH columns; `fwd_tile` picks (BN, BH) from
(n, k, h) and the wrapper passes it to the C entry point.

The d-coords kernel owns (BP points x CT centers) tiles: `bwd_points_tile`
picks them from (n, k, h) and splits k into `bwd_points_slabs` k-slabs so
that small N still fills the card. With more than one k-slab it writes
per-point partials to a workspace (slabs, N, 2) and a second kernel sums
them in slab order; with one it writes d coords directly.

dW and d centers contract over the N points. Their kernels split N into
slabs, one block per (output tile, slab), and write partial sums to a
workspace that the wrapper allocates: (S, k, h) for dW, (S, k, 3) for
(d cx, d cy, d inv_bw). A second kernel sums the S partials in slab order,
so each of these wrappers makes two device launches a call and its results
are bitwise deterministic. The slab count S is a function of (n, k, h)
alone (`bwd_w_slabs`, `bwd_centers_slabs`; slabs per `slab_bounds`).

The forward, dW and d centers (the kernels a fit trains through) take a
lane axis: coords (M, N, 2), centers (M, k, 2), inv_bw (M, k), w (M, k, H)
and g (M, N, H) are M independent fits, and one launch (plus its slab sum)
serves them all, the lane being one more grid dimension. The tiles and slab
counts stay chosen by one lane's N. The two-dimensional call is the M = 1
case of the same kernels. The plain versions broadcast over the lane axis.

Each wrapper counts its calls that reach the card by shape (`_LAUNCHES`,
an `_launch.LaunchCounter`): one a call, however many device launches the
call makes and however many lanes it serves; `launch_counts()` and
`launch_shapes()` read it. Where two threads launch (the batch pipeline's
finalize thread predicts while the main thread trains) they count both
threads' launches together.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Tuple

import torch

from st_dadk_tpu_torch.ops._build import load_library
from st_dadk_tpu_torch.ops._launch import (LaunchCounter, check,
                                           check_basis, check_basis_lanes,
                                           on_cpu, raise_on, stream)
from st_dadk_tpu_torch.ops.basis import (BASIS_IDS, CALIBRATION_FACTORS,
                                         basis_matrix)

_BASIS_NAMES = {v: k for k, v in BASIS_IDS.items()}
_LIB_NAME = "fused_first_layer"
_WHAT = "fused first layer"
_P, _I = ctypes.c_void_p, ctypes.c_int


_KERNELS = None   # (fwd, bwd_w, bwd_centers, bwd_points) C entry points
# (pointer, int) argument counts of each entry point before its stream
_SIGNATURES = (("st_fused_first_layer_fwd", 5, 7),
               ("st_fused_first_layer_bwd_w", 6, 6),
               ("st_fused_first_layer_bwd_centers", 8, 6),
               ("st_fused_first_layer_bwd_points", 7, 7))


def _kernels():
    """The library's four entry points, built, loaded and typed at the
    first launch on a CUDA tensor."""
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
# Tiles of the forward kernel (fwd_kernel)
# ---------------------------------------------------------------------------

# (points, hidden) tiles the C entry point launches, fewest phi builds first
FWD_TILES = ((64, 256), (64, 128), (32, 64), (16, 64))
FWD_MIN_BLOCKS = 128  # about one block an SM


def fwd_tile(n: int, k: int, h: int) -> Tuple[int, int]:
    """(BN, BH) of the forward kernel: the first tile of FWD_TILES no wider
    than H rounded up to 64 that gives at least FWD_MIN_BLOCKS blocks, else
    the smallest. Each point's phi is built ceil(h / BH) times. k does not
    enter: the kernel walks k in chunks whatever its size."""
    del k
    wide = max(64, -(-h // 64) * 64)
    fits = [t for t in FWD_TILES if t[1] <= wide]
    for bn, bh in fits:
        if -(-n // bn) * -(-h // bh) >= FWD_MIN_BLOCKS:
            return bn, bh
    return fits[-1]


# ---------------------------------------------------------------------------
# Tiles and k-slabs of the d-coords kernel (bwd_points_kernel)
# ---------------------------------------------------------------------------

# (points, centers) tiles the C entry point launches, fewest g stagings first
BP_TILES = ((64, 256), (32, 64), (16, 64))
BP_MIN_BLOCKS = 128   # about one block an SM


def bwd_points_tile(n: int, k: int, h: int) -> Tuple[int, int]:
    """(BP, CT) of the d-coords kernel: the first tile of BP_TILES no wider
    than k rounded up to 64 that gives at least BP_MIN_BLOCKS blocks of BP
    points x one k-slab of CT centers, else the smallest. Each point
    tile's g is staged ceil(k / CT) times. h does not enter: the kernel
    walks H in stages whatever its size."""
    del h
    wide = max(64, -(-k // 64) * 64)
    fits = [t for t in BP_TILES if t[1] <= wide]
    for bp, ct in fits:
        if -(-n // bp) * -(-k // ct) >= BP_MIN_BLOCKS:
            return bp, ct
    return fits[-1]


def bwd_points_slabs(n: int, k: int, h: int) -> int:
    """k-slabs of the d-coords kernel: one a CT-center tile."""
    return -(-k // bwd_points_tile(n, k, h)[1])


def bwd_points_workspace(n: int, k: int, h: int, device) -> torch.Tensor:
    """(slabs, n, 2) partials; unused (and 0 slabs long) with one k-slab,
    where the kernel writes d coords itself."""
    slabs = bwd_points_slabs(n, k, h)
    return torch.empty((slabs if slabs > 1 else 0, n, 2),
                       dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# Slabs of the split-N kernels (bwd_w_kernel, bwd_centers_kernel)
# ---------------------------------------------------------------------------

SM_COUNT = 132        # SMs of an H100 SXM
TARGET_BLOCKS = 4 * SM_COUNT   # both kernels keep four blocks an SM resident
SLAB_UNIT = 64        # points: a slab is a whole number of these
BW_TILE = (32, 128)   # bwd_w_kernel's block tile: centers x hidden
BC_TILE = 16          # bwd_centers_kernel's block tile: centers


def _n_slabs(n: int, tiles: int) -> int:
    """Slabs for `tiles` output tiles: as many as keep tiles x slabs within
    TARGET_BLOCKS, each at least SLAB_UNIT points, none empty."""
    units = -(-n // SLAB_UNIT)
    per = -(-units // max(1, min(units, TARGET_BLOCKS // tiles)))
    return -(-units // per)


def bwd_w_slabs(n: int, k: int, h: int) -> int:
    return _n_slabs(n, -(-k // BW_TILE[0]) * -(-h // BW_TILE[1]))


def bwd_centers_slabs(n: int, k: int) -> int:
    return _n_slabs(n, -(-k // BC_TILE))


def slab_bounds(n: int, slabs: int):
    """[(begin, end)] of each slab: the kernels' rule (`slab_range` in
    csrc/slabs.cuh)."""
    units = -(-n // SLAB_UNIT)
    length = SLAB_UNIT * -(-units // slabs)
    return [(min(n, s * length), min(n, (s + 1) * length))
            for s in range(slabs)]


MAX_GRID_YZ = 65535   # where a grid's y and z dimensions end


def bwd_w_workspace(n: int, k: int, h: int, device,
                    lead: Tuple[int, ...] = ()) -> torch.Tensor:
    """(slabs, k, h) partials, behind the lane axis `lead` = (M,) if any."""
    return torch.empty(lead + (bwd_w_slabs(n, k, h), k, h),
                       dtype=torch.float32, device=device)


def bwd_centers_workspace(n: int, k: int, device,
                          lead: Tuple[int, ...] = ()) -> torch.Tensor:
    """(slabs, k, 3) partials, behind the lane axis `lead` = (M,) if any."""
    return torch.empty(lead + (bwd_centers_slabs(n, k), k, 3),
                       dtype=torch.float32, device=device)


def _lanes(what: str, lead: Tuple[int, ...], slabs: int = 1) -> int:
    """The lane count of a launch; raises where lanes x slabs would pass
    the end of a grid dimension (the C entry point refuses it too)."""
    lanes = lead[0] if lead else 1
    if lanes * slabs > MAX_GRID_YZ:
        raise ValueError(f"{what}: {lanes} lanes x {slabs} slabs exceed the "
                         f"grid's {MAX_GRID_YZ}")
    return lanes


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path and the on-card reference)
# ---------------------------------------------------------------------------

# Each broadcasts over a leading lane axis: lanes share no operand, so a
# lane's result (and, through autograd, its gradient) is its own.

def plain_fwd(coords, centers, inv_bw, w, basis_id: int) -> torch.Tensor:
    return basis_matrix(coords, centers, inv_bw, _BASIS_NAMES[basis_id]) @ w


def plain_bwd_w(coords, centers, inv_bw, g, basis_id: int) -> torch.Tensor:
    phi = basis_matrix(coords, centers, inv_bw, _BASIS_NAMES[basis_id])
    return phi.transpose(-1, -2) @ g


def plain_bwd_centers(coords, centers, inv_bw, w, g, basis_id: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(d centers (k, 2), d inv_bw (k,)) by autograd through `plain_fwd`
    (a leading lane axis on every operand is kept)."""
    with torch.enable_grad():
        c = centers.detach().requires_grad_(True)
        ib = inv_bw.detach().requires_grad_(True)
        out = plain_fwd(coords.detach(), c, ib, w.detach(), basis_id)
        dc, dib = torch.autograd.grad(out, (c, ib), grad_outputs=g)
    return dc, dib


def plain_bwd_points(coords, centers, inv_bw, w, g, basis_id: int
                     ) -> torch.Tensor:
    """d coords (N, 2) by autograd through `plain_fwd`."""
    with torch.enable_grad():
        s = coords.detach().requires_grad_(True)
        out = plain_fwd(s, centers.detach(), inv_bw.detach(), w.detach(),
                        basis_id)
        (ds,) = torch.autograd.grad(out, (s,), grad_outputs=g)
    return ds


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _count(fn, lead: Tuple[int, ...], n: int, k: int, h: int,
           basis_id: int) -> None:
    """One launch of `fn`'s kernel, and the shape it launched at."""
    _LAUNCHES.add(fn, (lead, n, k, h, False, basis_id))


def fused_first_layer_fwd(coords: torch.Tensor, centers: torch.Tensor,
                          inv_bw: torch.Tensor, w: torch.Tensor,
                          basis_id: int) -> torch.Tensor:
    """h = phi(coords; centers, inv_bw) @ w: (N, 2), (k, 2), (k,), (k, H)
    -> (N, H) float32; with a lane axis (M, N, 2), (M, k, 2), (M, k),
    (M, k, H) -> (M, N, H) in one launch."""
    if on_cpu(_WHAT, coords, centers, inv_bw, w):
        return plain_fwd(coords, centers, inv_bw, w, basis_id)
    h = w.shape[-1]
    lead, n, k = check_basis_lanes(_WHAT, coords, centers, inv_bw, basis_id,
                                   h)
    check("w", w, lead + (k, h))
    lanes = _lanes("fused_first_layer_fwd", lead)
    out = torch.empty(lead + (n, h), dtype=torch.float32,
                      device=coords.device)
    with torch.cuda.device(coords.device):
        rc = _kernels()[0](
            coords.data_ptr(), centers.data_ptr(), inv_bw.data_ptr(),
            w.data_ptr(), out.data_ptr(), n, k, h, basis_id,
            *fwd_tile(n, k, h), lanes, stream(coords))
    raise_on(rc, "fused_first_layer_fwd")
    _count(fused_first_layer_fwd, lead, n, k, h, basis_id)
    return out


def fused_first_layer_bwd_w(coords: torch.Tensor, centers: torch.Tensor,
                            inv_bw: torch.Tensor, g: torch.Tensor,
                            basis_id: int) -> torch.Tensor:
    """dW = phi^T g: g (N, H) -> (k, H) float32; with a lane axis g
    (M, N, H) -> (M, k, H) in one launch and one slab sum."""
    if on_cpu(_WHAT, coords, centers, inv_bw, g):
        return plain_bwd_w(coords, centers, inv_bw, g, basis_id)
    h = g.shape[-1]
    lead, n, k = check_basis_lanes(_WHAT, coords, centers, inv_bw, basis_id,
                                   h)
    check("g", g, lead + (n, h))
    dw = torch.empty(lead + (k, h), dtype=torch.float32,
                     device=coords.device)
    ws = bwd_w_workspace(n, k, h, coords.device, lead)
    slabs = ws.shape[-3]
    lanes = _lanes("fused_first_layer_bwd_w", lead, slabs)
    with torch.cuda.device(coords.device):
        rc = _kernels()[1](
            coords.data_ptr(), centers.data_ptr(), inv_bw.data_ptr(),
            g.data_ptr(), dw.data_ptr(), ws.data_ptr(), n, k, h, basis_id,
            slabs, lanes, stream(coords))
    raise_on(rc, "fused_first_layer_bwd_w")
    _count(fused_first_layer_bwd_w, lead, n, k, h, basis_id)
    return dw


def fused_first_layer_bwd_centers(coords: torch.Tensor, centers: torch.Tensor,
                                  inv_bw: torch.Tensor, w: torch.Tensor,
                                  g: torch.Tensor, basis_id: int
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(d centers (k, 2), d inv_bw (k,)) through gw = g @ w^T; with a lane
    axis ((M, k, 2), (M, k)) in one launch and one slab sum."""
    if on_cpu(_WHAT, coords, centers, inv_bw, w, g):
        return plain_bwd_centers(coords, centers, inv_bw, w, g, basis_id)
    h = w.shape[-1]
    lead, n, k = check_basis_lanes(_WHAT, coords, centers, inv_bw, basis_id,
                                   h)
    check("w", w, lead + (k, h))
    check("g", g, lead + (n, h))
    dc = torch.empty(lead + (k, 2), dtype=torch.float32,
                     device=coords.device)
    dib = torch.empty(lead + (k,), dtype=torch.float32, device=coords.device)
    ws = bwd_centers_workspace(n, k, coords.device, lead)
    lanes = _lanes("fused_first_layer_bwd_centers", lead)
    with torch.cuda.device(coords.device):
        rc = _kernels()[2](
            coords.data_ptr(), centers.data_ptr(), inv_bw.data_ptr(),
            w.data_ptr(), g.data_ptr(), dc.data_ptr(), dib.data_ptr(),
            ws.data_ptr(), n, k, h, basis_id, ws.shape[-3], lanes,
            stream(coords))
    raise_on(rc, "fused_first_layer_bwd_centers")
    _count(fused_first_layer_bwd_centers, lead, n, k, h, basis_id)
    return dc, dib


def fused_first_layer_bwd_points(coords: torch.Tensor, centers: torch.Tensor,
                                 inv_bw: torch.Tensor, w: torch.Tensor,
                                 g: torch.Tensor, basis_id: int
                                 ) -> torch.Tensor:
    """d coords (N, 2) through gw = g @ w^T."""
    if on_cpu(_WHAT, coords, centers, inv_bw, w, g):
        return plain_bwd_points(coords, centers, inv_bw, w, g, basis_id)
    h = w.shape[-1]
    n, k = check_basis(_WHAT, coords, centers, inv_bw, basis_id, h)
    check("w", w, (k, h))
    check("g", g, (n, h))
    ds = torch.empty((n, 2), dtype=torch.float32, device=coords.device)
    ws = bwd_points_workspace(n, k, h, coords.device)
    with torch.cuda.device(coords.device):
        rc = _kernels()[3](
            coords.data_ptr(), centers.data_ptr(), inv_bw.data_ptr(),
            w.data_ptr(), g.data_ptr(), ds.data_ptr(), ws.data_ptr(), n, k,
            h, basis_id, *bwd_points_tile(n, k, h), bwd_points_slabs(n, k, h),
            stream(coords))
    raise_on(rc, "fused_first_layer_bwd_points")
    _count(fused_first_layer_bwd_points, (), n, k, h, basis_id)
    return ds


KERNEL_WRAPPERS = (fused_first_layer_fwd, fused_first_layer_bwd_w,
                   fused_first_layer_bwd_centers, fused_first_layer_bwd_points)


_LAUNCHES = LaunchCounter(KERNEL_WRAPPERS)


def reset_launch_counts() -> None:
    _LAUNCHES.reset()


def launch_counts() -> Dict[str, int]:
    return _LAUNCHES.counts()


def launch_shapes() -> Dict[str, List[Tuple]]:
    """Each kernel's distinct launch shapes since the last reset, as
    (lane axis, N, k, H, masked, basis id)."""
    return _LAUNCHES.shapes()


# ---------------------------------------------------------------------------
# Differentiable entry point
# ---------------------------------------------------------------------------

class FusedFirstLayer(torch.autograd.Function):
    """h = phi(coords; centers, inv_bw) @ w with kernel backward passes;
    each backward kernel launches only when its inputs need a gradient."""

    @staticmethod
    def forward(ctx, coords, centers, inv_bw, w, basis_id: int):
        ctx.save_for_backward(coords, centers, inv_bw, w)
        ctx.basis_id = basis_id
        return fused_first_layer_fwd(coords, centers, inv_bw, w, basis_id)

    @staticmethod
    def backward(ctx, g):
        coords, centers, inv_bw, w = ctx.saved_tensors
        g = g.contiguous()
        ds = dw = dc = dib = None
        if ctx.needs_input_grad[0]:
            if coords.dim() == 3:
                raise NotImplementedError(
                    "the fused d-coords kernel has no lane axis: take a "
                    "spatial gradient lane by lane")
            ds = fused_first_layer_bwd_points(coords, centers, inv_bw, w, g,
                                              ctx.basis_id)
        if ctx.needs_input_grad[3]:
            dw = fused_first_layer_bwd_w(coords, centers, inv_bw, g,
                                         ctx.basis_id)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dc, dib = fused_first_layer_bwd_centers(coords, centers, inv_bw,
                                                    w, g, ctx.basis_id)
        return ds, dc, dib, dw, None


def fused_spatial_first_layer(coords: torch.Tensor, centers: torch.Tensor,
                              bandwidths: torch.Tensor, w_spatial: torch.Tensor,
                              basis_function: str = "wendland") -> torch.Tensor:
    """Differentiable h1_spatial = phi(coords) @ w_spatial: coords (N, 2),
    centers (k, 2), bandwidths (k,), w_spatial (k, H) -> (N, H), or with a
    lane axis on all four (M, ...) -> (M, N, H). With lanes, coords are
    data: their gradient (the d-coords kernel) has no lane axis yet."""
    inv_bw = 1.0 / (bandwidths * CALIBRATION_FACTORS[basis_function])
    return FusedFirstLayer.apply(coords.contiguous(), centers.contiguous(),
                                 inv_bw.contiguous(), w_spatial.contiguous(),
                                 BASIS_IDS[basis_function])
