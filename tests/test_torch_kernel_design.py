"""The design of the fused forward kernel (`fwd_kernel` in
st_dadk_tpu_torch/csrc/fused_first_layer.cu) and the basis d-centers kernel
(`bwd_centers_kernel` in csrc/spatial_basis.cu), pinned on the CPU.

The kernels run only on the card, where chip_smoke.py holds them against
their plain versions and checks that two launches agree bitwise. Here: the
planners that size their grids (`fwd_tile`, `basis_bwd_centers_slabs`) and
the workspace, Python mirrors that compute the plain version tile by tile
and slab by slab in the kernels' order (against the whole plain version and
the JAX package's jnp oracle), the ctypes signatures of the C entry points,
and a numpy emulation of TF32 that shows why the forward takes three TF32
products (3xTF32) and not one.
Bars: forward atol 1e-4 (tests/test_pallas_fused.py:40); basis gradients
rtol 5e-3 / atol 5e-4 (tests/test_pallas_basis.py:63).
"""
import ctypes
import re
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from st_dadk_tpu.ops.basis import spatial_basis_embed as jnp_embed
from st_dadk_tpu_torch.ops import fused_first_layer as ffl
from st_dadk_tpu_torch.ops import spatial_basis_kernels as sbk
from test_torch_fused_backward_design import (_bench_operands,
                                              _product_3xtf32, _tf32)
from torch_threads import worker_threads  # noqa: F401

FWD_ATOL = 1e-4
GRAD_RTOL, GRAD_ATOL = 5e-3, 5e-4
CSRC = Path(ffl.__file__).resolve().parent.parent / "csrc"
FUSED = (CSRC / "fused_first_layer.cu").read_text()
BASIS = (CSRC / "spatial_basis.cu").read_text()
SLABS = (CSRC / "slabs.cuh").read_text()


def _code(text):
    return re.sub(r"//[^\n]*", "", text)        # without the comments


def _const(text, name):
    return int(re.search(r"constexpr int %s = (\d+);" % name,
                         _code(text)).group(1))


FIT_SHAPES = [(512, 227, 256), (2000, 227, 256), (32768, 227, 256)]
ODD_SHAPES = [(200, 106, 48), (77, 37, 19), (1, 1, 1), (63, 5, 300),
              (5000, 500, 1024)]


# ---------------------------------------------------------------------------
# fwd_tile: the forward's grid
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,k,h", FIT_SHAPES + ODD_SHAPES)
def test_fwd_tiles_cover_every_output_once(n, k, h):
    bn, bh = ffl.fwd_tile(n, k, h)
    assert (bn, bh) in ffl.FWD_TILES
    seen = np.zeros((n, h), dtype=np.int32)
    for bx in range(-(-n // bn)):
        for by in range(-(-h // bh)):
            seen[bx * bn:(bx + 1) * bn, by * bh:(by + 1) * bh] += 1
    assert seen.min() == 1 and seen.max() == 1


def test_fwd_tile_fills_the_card_and_builds_phi_at_most_twice():
    """The training step gets at least 128 blocks (16 x 64: phi built 4
    times a point, for 16 points a block); the predict chunk builds each
    point's phi at most twice; no tile is wider than H needs."""
    def blocks(n, k, h):
        bn, bh = ffl.fwd_tile(n, k, h)
        return -(-n // bn) * -(-h // bh)

    assert ffl.fwd_tile(512, 227, 256) == (16, 64)
    assert blocks(512, 227, 256) >= 128
    assert blocks(2000, 227, 256) >= 128
    assert -(-256 // ffl.fwd_tile(32768, 227, 256)[1]) <= 2
    for n, k, h in ODD_SHAPES:
        assert ffl.fwd_tile(n, k, h)[1] <= max(64, -(-h // 64) * 64)


def _fwd_instances():
    """{(BN, BH): (warps along points, centers a chunk)} of the template
    instances the C entry point launches."""
    entry = re.search(r"int st_fused_first_layer_fwd\(.*?\n}\n",
                      _code(FUSED), re.S).group(0)
    return {(int(bn), int(bh)): (int(wm), int(kc)) for bn, bh, wm, kc in
            re.findall(r"launch_fwd<(\d+), (\d+), (\d+), (\d+)>", entry)}


def test_fwd_tiles_are_the_ones_the_entry_point_launches():
    """Every planner tile has a template instance in the C entry point; its
    warps tile it in 16 x 8 mma tiles, and its chunk is whole mma k-steps
    with one center a thread."""
    inst = _fwd_instances()
    assert set(inst) == set(ffl.FWD_TILES)
    threads = _const(FUSED, "THREADS")
    for (bn, bh), (wm, kc) in inst.items():
        wn = threads // 32 // wm
        assert bn % (16 * wm) == 0 and bh % (8 * wn) == 0 and bh % 32 == 0
        assert kc % 8 == 0 and threads % kc == 0


def _mirror_fwd(coords, centers, inv_bw, w, basis_id):
    """h tile by tile (fwd_tile) and k chunk by chunk in order, as the
    kernel sums it, from the plain phi."""
    n, k, h = coords.shape[0], centers.shape[0], w.shape[1]
    bn, bh = ffl.fwd_tile(n, k, h)
    kc = _fwd_instances()[(bn, bh)][1]
    out = torch.full((n, h), float("nan"))
    for n0 in range(0, n, bn):
        phi = ffl.basis_matrix(coords[n0:n0 + bn], centers, inv_bw,
                               ffl._BASIS_NAMES[basis_id])
        for h0 in range(0, h, bh):
            acc = torch.zeros((phi.shape[0], w[:, h0:h0 + bh].shape[1]))
            for c0 in range(0, k, kc):
                acc += phi[:, c0:c0 + kc] @ w[c0:c0 + kc, h0:h0 + bh]
            out[n0:n0 + bn, h0:h0 + bh] = acc
    return out


@pytest.mark.parametrize("basis", ["wendland", "gaussian", "triangular"])
@pytest.mark.parametrize("n,k,h", [(300, 227, 256), (77, 37, 19),
                                   (200, 106, 48)])
def test_fwd_mirror_matches_plain_and_jax(n, k, h, basis):
    rng = np.random.default_rng(n + k + h)
    coords = rng.uniform(size=(n, 2)).astype(np.float32)
    centers = rng.uniform(size=(k, 2)).astype(np.float32)
    bw = rng.uniform(0.1, 0.8, size=k).astype(np.float32)
    w = (0.1 * rng.normal(size=(k, h))).astype(np.float32)
    cal = ffl.CALIBRATION_FACTORS[basis]
    inv_bw = (1.0 / (bw * np.float32(cal))).astype(np.float32)
    t = [torch.as_tensor(a) for a in (coords, centers, inv_bw, w)]
    bid = ffl.BASIS_IDS[basis]
    got = _mirror_fwd(*t, bid).numpy()
    assert np.all(np.isfinite(got))
    plain = ffl.plain_fwd(*t, bid).numpy()
    np.testing.assert_allclose(got, plain, rtol=0, atol=1e-5)
    want = np.asarray(jnp_embed(jnp.asarray(coords), jnp.asarray(centers),
                                jnp.asarray(bw), basis)
                      @ jnp.asarray(w))
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_ATOL)


# ---------------------------------------------------------------------------
# basis_bwd_centers_slabs: the d-centers kernel's grid and workspace
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 63, 64, 200, 512, 2000, 32768])
@pytest.mark.parametrize("k", [227, 106, 37, 1, 500])
def test_basis_slabs_cover_the_points_once_in_order(n, k):
    slabs = sbk.basis_bwd_centers_slabs(n, k)
    tiles = -(-k // sbk.BBC_TILE)
    assert slabs >= 1
    assert slabs == 1 or tiles * slabs <= ffl.TARGET_BLOCKS
    bounds = ffl.slab_bounds(n, slabs)
    assert bounds[0][0] == 0 and bounds[-1][1] == n
    for (_, e0), (b1, _) in zip(bounds, bounds[1:]):
        assert e0 == b1                             # in order, no gap
    assert all(e > b for b, e in bounds)            # no empty slab
    assert all((e - b) % ffl.SLAB_UNIT == 0 for b, e in bounds[:-1])
    assert tuple(sbk.basis_bwd_centers_workspace(n, k, "meta").shape) == (
        slabs, k, 3)


def test_basis_slabs_at_the_fit_shapes():
    """8 center tiles at k=227: one 64-point unit a slab at N=512 and
    N=2000 (64 and 256 blocks, against 8 for a kernel that walks all N),
    64 slabs of 512 points at N=32768 (512 blocks)."""
    assert sbk.basis_bwd_centers_slabs(512, 227) == 8
    assert sbk.basis_bwd_centers_slabs(2000, 227) == 32
    assert sbk.basis_bwd_centers_slabs(32768, 227) == 64
    blocks = 8 * sbk.basis_bwd_centers_slabs(32768, 227)
    assert 2 * ffl.SM_COUNT < blocks <= ffl.TARGET_BLOCKS


def test_basis_planner_tiles_are_the_kernels():
    assert _const(BASIS, "BC_CT") == sbk.BBC_TILE == 32   # one per lane
    assert _const(SLABS, "SLAB_UNIT") == ffl.SLAB_UNIT
    for text in (FUSED, BASIS):
        assert '#include "slabs.cuh"' in text
        assert "slab_range" in _code(text)
    for name in ("slab_range", "slab_sum_kernel", "centers_sum_kernel"):
        assert name in _code(SLABS)
        assert f"void {name}(" not in _code(FUSED) + _code(BASIS)
    assert "atomic" not in _code(BASIS) + _code(SLABS)


@pytest.mark.parametrize("basis", ["wendland", "gaussian", "triangular"])
@pytest.mark.parametrize("n,k", [(700, 227), (200, 106), (77, 37)])
def test_basis_slab_mirror_matches_plain_and_jax(n, k, basis):
    """d centers and d inv_bw as the kernel forms them: the plain version
    on each slab's points, summed in slab order; against the whole plain
    version and JAX's gradient of the jnp oracle."""
    rng = np.random.default_rng(7 * n + k)
    coords = rng.uniform(size=(n, 2)).astype(np.float32)
    centers = rng.uniform(size=(k, 2)).astype(np.float32)
    centers[:3] = coords[:3]                       # zero distances too
    bw = rng.uniform(0.1, 0.8, size=k).astype(np.float32)
    g = (rng.normal(size=(n, k)) / n).astype(np.float32)
    inv_bw = (1.0 / (bw * np.float32(sbk.CALIBRATION_FACTORS[basis]))
              ).astype(np.float32)
    bid = sbk.BASIS_IDS[basis]
    t = [torch.as_tensor(a) for a in (coords, centers, inv_bw, g)]
    slabs = sbk.basis_bwd_centers_slabs(n, k)
    ws = np.zeros((slabs, k, 3), dtype=np.float32)
    for s, (b, e) in enumerate(ffl.slab_bounds(n, slabs)):
        dc, dib = sbk.plain_bwd_centers(t[0][b:e], t[1], t[2], t[3][b:e],
                                        bid)
        ws[s, :, :2], ws[s, :, 2] = dc.numpy(), dib.numpy()
    total = ws[0].copy()
    for s in range(1, slabs):
        total += ws[s]
    dc, dib = sbk.plain_bwd_centers(*t, bid)
    np.testing.assert_allclose(total[:, :2], dc.numpy(), rtol=1e-4,
                               atol=1e-7)
    np.testing.assert_allclose(total[:, 2], dib.numpy(), rtol=1e-4,
                               atol=1e-7)
    G = jnp.asarray(g)
    want = jax.grad(lambda c, b_: jnp.sum(
        jnp_embed(jnp.asarray(coords), c, b_, basis) * G), argnums=(0, 1))(
        jnp.asarray(centers), jnp.asarray(bw))
    # d bandwidth = d inv_bw * d inv_bw / d bw = -d inv_bw * inv_bw / bw
    dbw = -total[:, 2] * inv_bw / bw
    np.testing.assert_allclose(total[:, :2], np.asarray(want[0]),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)
    np.testing.assert_allclose(dbw, np.asarray(want[1]), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)


# ---------------------------------------------------------------------------
# The C entry points of spatial_basis.cu, as the wrapper types them
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,n_ptr,n_int", sbk._SIGNATURES)
def test_basis_ctypes_signatures_match_the_c_entry_points(name, n_ptr, n_int,
                                                          monkeypatch):
    m = re.search(r"int %s\(([^)]*)\)" % name, BASIS)
    assert m, name
    params = [" ".join(p.split()[:-1]) for p in m.group(1).split(",")]
    assert params[-1] == "void*"
    assert [p.endswith("*") for p in params[:-1]] == (
        [True] * n_ptr + [False] * n_int)
    assert all(p == "int" for p in params[n_ptr:-1])
    fake = types.SimpleNamespace(**{nm: types.SimpleNamespace()
                                    for nm, _, _ in sbk._SIGNATURES})
    monkeypatch.setattr(sbk, "load_library", lambda _: fake)
    monkeypatch.setattr(sbk, "_KERNELS", None)
    sbk._kernels()
    fn = getattr(fake, name)
    assert fn.argtypes == ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                           + [ctypes.c_void_p])
    assert fn.restype is ctypes.c_int


@pytest.mark.parametrize("name,kernel", [
    ("void (anonymous namespace)::fwd_kernel<16, 64, 1, 64, 256>(float "
     "const*, float const*, float const*, float const*, float*, int, int, "
     "int, int, bool)", "fwd_kernel"),
    ("(anonymous namespace)::bwd_centers_kernel(float const*, float const*, "
     "float const*, float const*, float*, int, int, int, int)",
     "bwd_centers_kernel"),
    ("st_slabs::centers_sum_kernel(float const*, float*, float*, int, int)",
     "centers_sum_kernel"),
    ("(anonymous namespace)::lane_clip_sumsq_kernel((anonymous namespace)::"
     "Leaves, float*, int, int)", "lane_clip_sumsq_kernel"),
    ("(anonymous namespace)::lane_clip_scale_kernel((anonymous namespace)::"
     "Leaves, (anonymous namespace)::ClipGroups, float const*, int)",
     "lane_clip_scale_kernel"),
    ("(anonymous namespace)::lane_adamw_kernel((anonymous namespace)::Leaves, "
     "(anonymous namespace)::Hyper, float const*, int, int, unsigned char "
     "const*, int, int const*, int*)", "lane_adamw_kernel"),
    ("(anonymous namespace)::lane_ema_kernel((anonymous namespace)::Leaves, "
     "float const*, int, float const*, int, unsigned char const*, int)",
     "lane_ema_kernel"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "CUDAFunctor_add<float>>(int)", None),
    ("void (anonymous namespace)::elementwise_kernel_with_index<int, "
     "at::native::arange_cuda_out>(int)", None),
])
def test_profile_attributes_the_port_kernels(name, kernel):
    """profile_fit reads a step's device time of each csrc kernel from the
    profiler's demangled names: templates, slabs.cuh's namespace, and no
    library kernel."""
    from st_dadk_tpu_torch.profile_fit import PORT_KERNEL
    m = PORT_KERNEL.match(name)
    assert (m.group(1) if m else None) == kernel


def test_fwd_entry_point_takes_the_tile():
    m = re.search(r"int st_fused_first_layer_fwd\(([^)]*)\)", FUSED)
    names = [p.split()[-1] for p in m.group(1).split(",")]
    assert names[-4:] == ["tile_n", "tile_h", "lanes", "stream"]


# ---------------------------------------------------------------------------
# 3xTF32 in the forward, emulated in numpy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [512, 2000])
def test_forward_single_tf32_misses_the_bar_and_3xtf32_meets_it(n):
    """h = phi W at the bench widths (k=227, H=256; W = 0.1 randn, about
    90 non-zero phi a row): one TF32 product is off by more than the
    forward's atol 1e-4 somewhere among the N x 256 outputs; 3xTF32 stays
    100x inside it."""
    phi, w, _ = _bench_operands(n)
    want = phi.astype(np.float64) @ w.astype(np.float64)
    one = np.abs(_tf32(phi) @ _tf32(w) - want).max()
    three = np.abs(_product_3xtf32(phi, w) - want).max()
    assert one > FWD_ATOL
    assert three < FWD_ATOL / 100


def _tf32_trunc(x):
    """A .tf32 operand as mma.sync reads a float32 register: the 13 low
    bits dropped (rounded toward zero)."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def _product_3xtf32_trunc(a, b):
    """a @ b as the forward takes it (split_tf32_trunc): hi = x with its
    low bits cleared, lo = x - hi (exact) read truncated by the mma."""
    a_hi, b_hi = _tf32_trunc(a), _tf32_trunc(b)
    a_lo, b_lo = _tf32_trunc(a - a_hi), _tf32_trunc(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def test_split_tf32_trunc_is_exact_to_2_pow_21():
    x = np.random.default_rng(0).normal(size=100000).astype(np.float32)
    hi = _tf32_trunc(x)
    lo = (x - hi).astype(np.float32)
    assert np.all(hi + lo == x)                      # x - hi is exact
    err = np.abs(hi.astype(np.float64) + _tf32_trunc(lo) - x)
    assert np.all(err <= 2.0 ** -21 * np.abs(x))


@pytest.mark.parametrize("n", [512, 2000])
def test_forward_truncating_3xtf32_meets_the_bar(n):
    """The forward's cheaper split keeps 3xTF32 100x inside atol 1e-4 at
    the bench widths, where one truncated TF32 product misses it."""
    phi, w, _ = _bench_operands(n)
    want = phi.astype(np.float64) @ w.astype(np.float64)
    one = np.abs(_tf32_trunc(phi) @ _tf32_trunc(w) - want).max()
    three = np.abs(_product_3xtf32_trunc(phi, w) - want).max()
    assert one > FWD_ATOL
    assert three < FWD_ATOL / 100


def test_forward_source_takes_the_truncating_split():
    """Every operand of the forward's mma goes through split_tf32_trunc."""
    body = re.search(r"fwd_kernel\(const float\*.*?\n}\n", _code(FUSED),
                     re.S).group(0)
    assert "split_tf32_trunc(" in body and "split_tf32(" not in body
    assert body.count("mma_3xtf32(") == 1
