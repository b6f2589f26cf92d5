"""The design of the fused first layer's split-N backward kernels
(`bwd_w_kernel`, `bwd_centers_kernel` in st_dadk_tpu_torch/csrc/
fused_first_layer.cu), pinned on the CPU.

The kernels themselves run only on the card, where chip_smoke.py holds them
against their plain versions and checks that two launches agree bitwise.
Here: the slab planner that sizes their grids and workspaces, the ctypes
signatures of their C entry points, and a numpy emulation of the TF32
rounding that shows why they take three TF32 products (3xTF32) and not one.
Bars: rtol 2e-4 / atol 2e-5 (tests/test_pallas_fused.py:92).
"""
import ctypes
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from st_dadk_tpu_torch.ops import fused_first_layer as ffl
from st_dadk_tpu_torch.ops.basis import basis_matrix
from torch_threads import worker_threads  # noqa: F401

GRAD_RTOL, GRAD_ATOL = 2e-4, 2e-5
CSRC = Path(ffl.__file__).resolve().parent.parent / "csrc"
SOURCE = (CSRC / "fused_first_layer.cu").read_text()
SLABS = (CSRC / "slabs.cuh").read_text()         # the slab rule it includes
ASYNC = (CSRC / "cp_async.cuh").read_text()      # its cp.async copies
CODE = re.sub(r"//[^\n]*", "", SOURCE + SLABS + ASYNC)  # without comments
SHAPES_KH = [(227, 256), (106, 48), (37, 19), (1, 1), (500, 1024)]


def _tiles(k, h):
    """Output tiles of (bwd_w_kernel, bwd_centers_kernel)."""
    return (-(-k // ffl.BW_TILE[0]) * -(-h // ffl.BW_TILE[1]),
            -(-k // ffl.BC_TILE))


@pytest.mark.parametrize("n", [1, 63, 64, 200, 512, 2000, 32768])
def test_slabs_cover_the_points_once_in_order(n):
    for k, h in SHAPES_KH:
        for slabs, tiles in ((ffl.bwd_w_slabs(n, k, h), _tiles(k, h)[0]),
                             (ffl.bwd_centers_slabs(n, k), _tiles(k, h)[1])):
            assert slabs >= 1
            assert slabs == 1 or tiles * slabs <= ffl.TARGET_BLOCKS
            bounds = ffl.slab_bounds(n, slabs)
            assert bounds[0][0] == 0 and bounds[-1][1] == n
            for (b0, e0), (b1, _) in zip(bounds, bounds[1:]):
                assert e0 == b1                      # in order, no gap
            for b, e in bounds:
                assert e > b                         # no empty slab
            for b, e in bounds[:-1]:
                assert (e - b) % ffl.SLAB_UNIT == 0  # whole 64-point units
        assert tuple(ffl.bwd_w_workspace(n, k, h, "meta").shape) == (
            ffl.bwd_w_slabs(n, k, h), k, h)
        assert tuple(ffl.bwd_centers_workspace(n, k, "meta").shape) == (
            ffl.bwd_centers_slabs(n, k), k, 3)


def test_slabs_fill_the_card_at_the_fit_shapes():
    """The training step (N=512): 8 slabs of 64 points, 128 and 120 blocks
    against 16 and 8 for kernels that walk all N; the predict chunk
    (N=32768): no more blocks than four an SM."""
    k, h = 227, 256
    tw, tc = _tiles(k, h)
    assert (ffl.bwd_w_slabs(512, k, h), ffl.bwd_centers_slabs(512, k)) == (
        8, 8)
    assert (tw * 8, tc * 8) == (128, 120)
    for n in (2000, 32768):
        for blocks in (tw * ffl.bwd_w_slabs(n, k, h),
                       tc * ffl.bwd_centers_slabs(n, k)):
            assert 2 * ffl.SM_COUNT < blocks <= 4 * ffl.SM_COUNT


def test_planner_tiles_are_the_kernels_tiles():
    """The planner counts the blocks the kernels launch: its tile sizes and
    slab unit are the source's."""
    def const(name):
        return int(re.search(r"constexpr int %s = (\d+);" % name,
                             CODE).group(1))
    assert (const("BW_BK"), const("BW_BH")) == ffl.BW_TILE
    assert const("BC_CT") == ffl.BC_TILE
    assert const("SLAB_UNIT") == ffl.SLAB_UNIT


def _c_params(name):
    """Parameter types of the C entry point `name` in the source."""
    m = re.search(r"int %s\(([^)]*)\)" % name, SOURCE)
    assert m, name
    return [" ".join(p.split()[:-1]) for p in m.group(1).split(",")]


@pytest.mark.parametrize("name,n_ptr,n_int", ffl._SIGNATURES)
def test_ctypes_signatures_match_the_c_entry_points(name, n_ptr, n_int,
                                                    monkeypatch):
    """The wrapper types each entry point as the source declares it:
    pointers, then ints, then the stream; bwd_w and bwd_centers take the
    workspace pointer and the slab count."""
    params = _c_params(name)
    assert params[-1] == "void*"                 # the stream
    assert [p.endswith("*") for p in params[:-1]] == (
        [True] * n_ptr + [False] * n_int)
    assert all(p == "int" for p in params[n_ptr:-1])
    fake = types.SimpleNamespace(**{nm: types.SimpleNamespace()
                                    for nm, _, _ in ffl._SIGNATURES})
    monkeypatch.setattr(ffl, "load_library", lambda _: fake)
    monkeypatch.setattr(ffl, "_KERNELS", None)
    fn = getattr(fake, name)
    ffl._kernels()
    assert fn.argtypes == ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                           + [ctypes.c_void_p])
    assert fn.restype is ctypes.c_int


def test_split_n_source_is_3xtf32_without_atomics():
    """Fixed-order sums only (deterministic), and every TF32 mma.sync is
    one of the three products of mma_3xtf32 (no single TF32 pass)."""
    assert "atomic" not in CODE
    assert CODE.count("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32") \
        == 1
    body = re.search(r"void mma_3xtf32\(.*?\n}\n", CODE, re.S).group(0)
    assert CODE.count("mma_tf32(") == 1 + body.count("mma_tf32(") == 4
    for op in ("cvt.rna.tf32.f32", "cp.async.cg.shared.global",
               "cp.async.commit_group", "cp.async.wait_group"):
        assert op in CODE, op


# ---------------------------------------------------------------------------
# 3xTF32, emulated in numpy
# ---------------------------------------------------------------------------

def _tf32(x):
    """cvt.rna.tf32.f32: keep 10 mantissa bits, round to nearest with ties
    away from zero (add half the dropped range to the magnitude bits)."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _product_3xtf32(a, b):
    """a @ b as the kernels take it: lo*hi + hi*lo + hi*hi, float32 sums."""
    a_hi, a_lo = _split(a)
    b_hi, b_lo = _split(b)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def _bench_operands(n, k=227, h=256, seed=0):
    """phi (n, k), W (k, h) and the gradient of a mean loss g (n, h) at the
    bench fit's widths."""
    rng = np.random.default_rng(seed)
    coords = rng.uniform(size=(n, 2)).astype(np.float32)
    centers = rng.uniform(size=(k, 2)).astype(np.float32)
    inv_bw = (1.0 / rng.uniform(0.1, 0.8, size=k)).astype(np.float32)
    w = (0.1 * rng.normal(size=(k, h))).astype(np.float32)
    g = (rng.normal(size=(n, h)) / n).astype(np.float32)
    phi = basis_matrix(torch.as_tensor(coords), torch.as_tensor(centers),
                       torch.as_tensor(inv_bw), "wendland").numpy()
    return phi, w, g


def _bar_use(got, want):
    """Worst |got - want| as a share of the bar atol + rtol |want|."""
    return float(np.max(np.abs(got - want) / (GRAD_ATOL
                                              + GRAD_RTOL * np.abs(want))))


@pytest.mark.parametrize("n", [512, 2000])
def test_3xtf32_products_meet_the_bars_with_100x_margin(n):
    phi, w, g = _bench_operands(n)
    f64 = np.float64
    for a, b in ((phi.T, g), (g, w.T)):            # dW = phi^T g, gw = g W^T
        want = a.astype(f64) @ b.astype(f64)
        assert _bar_use(_product_3xtf32(a, b), want) <= 0.01


@pytest.mark.parametrize("n", [512, 2000])
def test_single_tf32_pass_breaks_the_gw_bar(n):
    """One TF32 product gives gw = g W^T a relative error (to its largest
    entry) past rtol 2e-4; 3xTF32 stays 100x inside it."""
    _, w, g = _bench_operands(n)
    want = g.astype(np.float64) @ w.T.astype(np.float64)
    scale = np.abs(want).max()
    one = np.abs(_tf32(g) @ _tf32(w.T) - want).max() / scale
    three = np.abs(_product_3xtf32(g, w.T) - want).max() / scale
    assert one > GRAD_RTOL
    assert three < GRAD_RTOL / 100
