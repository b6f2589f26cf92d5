"""The design of the basis phi forward (`fwd_kernel<CPT>` in
st_dadk_tpu_torch/csrc/spatial_basis.cu) and the fused d-coords kernel
(`bwd_points_kernel` in csrc/fused_first_layer.cu), pinned on the CPU.

The kernels run only on the card, where chip_smoke.py holds them against
their plain versions and checks that two launches agree bitwise. Here: the
planners that size their grids (`basis_fwd_plan`, `bwd_points_tile`,
`bwd_points_slabs`) cover every (point, center) pair once and launch only
the template instances of the C entry points; the entry points take the
planners' arguments; and a numpy mirror of the d-coords kernel's arithmetic
(3xTF32 gw with the truncating split, the chain in float32, the per-thread,
lane, warp and k-slab sums in the kernel's order) meets the gradient bar
against the plain version and the JAX fused kernel in interpret mode.
Bars: rtol 2e-4 / atol 2e-5 (tests/test_pallas_fused.py:92).
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from st_dadk_tpu_torch.ops import fused_first_layer as ffl
from st_dadk_tpu_torch.ops import spatial_basis_kernels as sbk
from test_torch_kernel_design import FIT_SHAPES, ODD_SHAPES, _const
from test_torch_kernel_design import _product_3xtf32_trunc
from torch_threads import worker_threads  # noqa: F401

GRAD_RTOL, GRAD_ATOL = 2e-4, 2e-5
CSRC = Path(ffl.__file__).resolve().parent.parent / "csrc"
FUSED = (CSRC / "fused_first_layer.cu").read_text()
BASIS = (CSRC / "spatial_basis.cu").read_text()
K500 = [(512, 500, 256), (2000, 500, 64), (32768, 500, 256)]


def _code(text):
    return re.sub(r"//[^\n]*", "", text)        # without the comments


def _entry(text, name):
    return re.search(r"int %s\(.*?\n}\n" % name, _code(text), re.S).group(0)


# ---------------------------------------------------------------------------
# basis_fwd_plan: the phi forward's tile walk
# ---------------------------------------------------------------------------

def _fwd_walk(n, k):
    """How often the forward's grid writes each phi element: block (bx, by)
    owns points [bx tile_p, + tile_p) and thread t of it centers c .. c +
    cpt - 1, c = (by threads + t) cpt, for the centers below k."""
    tile_p, cpt, threads = sbk.basis_fwd_plan(n, k)
    span = threads * cpt
    seen = np.zeros((n, k), dtype=np.int32)
    for by in range(-(-k // span)):
        cols = np.arange(by * span, (by + 1) * span).reshape(threads, cpt)
        cols = cols[cols[:, 0] < k].ravel()       # the threads that store
        for bx in range(-(-n // tile_p)):
            seen[bx * tile_p:(bx + 1) * tile_p, cols] += 1
    return seen


@pytest.mark.parametrize("n,k,h", FIT_SHAPES + ODD_SHAPES + K500)
def test_basis_fwd_walk_writes_every_element_once(n, k, h):
    seen = _fwd_walk(n, k)
    assert seen.min() == 1 and seen.max() == 1


@pytest.mark.parametrize("n,k,h", FIT_SHAPES + ODD_SHAPES + K500)
def test_basis_fwd_plan_is_an_instance_the_entry_point_launches(n, k, h):
    """Whole warps of at most 256 threads; a tile within the kernel's
    shared arrays; 4 centers a thread only where k % 4 == 0 (a row's
    16-byte stores stay aligned); at most 65535 center chunks."""
    tile_p, cpt, threads = sbk.basis_fwd_plan(n, k)
    entry = _entry(BASIS, "st_spatial_basis_fwd")
    launched = {int(c) for c in re.findall(r"fwd_kernel<(\d+)><<<", entry)}
    assert launched == {1, 4}
    assert cpt in launched and (cpt == 1 or k % 4 == 0)
    assert 1 <= tile_p <= _const(BASIS, "FWD_MAX_TILE_P")
    assert threads % 32 == 0 and 32 <= threads <= _const(BASIS, "THREADS")
    assert -(-k // (threads * cpt)) <= 65535
    # no warp lies wholly past k
    chunks = -(-k // (threads * cpt))
    assert threads - 32 < -(-k // cpt) / chunks <= threads


def test_basis_fwd_plan_fills_the_card_at_the_fit_shapes():
    """About two blocks an SM or more at every fit shape (no fixed cap on
    the grid), 16 points a block at N=32,768; 227 centers (odd k) take one
    center a thread, 300 and 500 four."""
    for n, tile in ((512, 2), (2000, 4), (32768, 16)):
        tile_p, cpt, threads = sbk.basis_fwd_plan(n, 227)
        assert (tile_p, cpt, threads) == (tile, 1, 256)
        assert -(-n // tile_p) >= sbk.BASIS_FWD_MIN_BLOCKS
    assert sbk.basis_fwd_plan(1000, 300)[1:] == (4, 96)
    assert sbk.basis_fwd_plan(5000, 500)[1:] == (4, 128)


def test_basis_fwd_source_has_no_division_in_the_element_loop():
    """The element loop steps rows by k; the old per-element `e / k` and
    its fixed 132 x 32 grid cap are gone."""
    body = re.search(r"fwd_kernel\(const float\*.*?\n}\n", _code(BASIS),
                     re.S).group(0)
    loop = body[body.index("for (int i = 0; i < np"):]
    assert "/" not in loop and "%" not in loop
    assert "132" not in _code(BASIS)
    assert "float4" in body


# ---------------------------------------------------------------------------
# bwd_points_tile / bwd_points_slabs: the d-coords kernel's grid
# ---------------------------------------------------------------------------

def _bp_instances():
    """{(BP, CT): (warps along points, hidden a stage)} of the template
    instances the C entry point launches."""
    entry = _entry(FUSED, "st_fused_first_layer_bwd_points")
    return {(int(bp), int(ct)): (int(wm), int(hc)) for bp, ct, wm, hc in
            re.findall(r"launch_bwd_points<(\d+), (\d+), (\d+), (\d+)>",
                       entry)}


@pytest.mark.parametrize("n,k,h", FIT_SHAPES + ODD_SHAPES + K500)
def test_bwd_points_tiles_and_slabs_cover_every_pair_once(n, k, h):
    """Point tiles x k-slabs cover each (point, center) pair once; the
    k-slabs follow each other in center order."""
    bp, ct = ffl.bwd_points_tile(n, k, h)
    slabs = ffl.bwd_points_slabs(n, k, h)
    assert (bp, ct) in ffl.BP_TILES and slabs == -(-k // ct)
    seen = np.zeros((n, k), dtype=np.int32)
    for bx in range(-(-n // bp)):
        for s in range(slabs):
            seen[bx * bp:(bx + 1) * bp, s * ct:(s + 1) * ct] += 1
    assert seen.min() == 1 and seen.max() == 1
    assert (slabs - 1) * ct < k <= slabs * ct     # no empty k-slab
    ws = ffl.bwd_points_workspace(n, k, h, "meta")
    assert tuple(ws.shape) == ((slabs if slabs > 1 else 0), n, 2)


def test_bwd_points_fills_the_card_at_the_fit_shapes():
    """About one block an SM at N=512 and N=2,000 (from 8 and 32 blocks);
    one k-slab at N=32,768, so each point tile stages its g once."""
    def blocks(n, k, h):
        bp, _ = ffl.bwd_points_tile(n, k, h)
        return -(-n // bp) * ffl.bwd_points_slabs(n, k, h)

    assert ffl.bwd_points_tile(512, 227, 256) == (16, 64)
    assert ffl.bwd_points_tile(2000, 227, 256) == (32, 64)
    assert ffl.bwd_points_tile(32768, 227, 256) == (64, 256)
    assert blocks(512, 227, 256) >= ffl.BP_MIN_BLOCKS == 128
    assert blocks(2000, 227, 256) >= 128
    assert ffl.bwd_points_slabs(32768, 227, 256) == 1
    for n, k, h in ODD_SHAPES:
        assert ffl.bwd_points_tile(n, k, h)[1] <= max(64, -(-k // 64) * 64)


def test_bwd_points_tiles_are_the_ones_the_entry_point_launches():
    """Every planner tile has a template instance in the C entry point; its
    warps tile it in 16 x 8 mma tiles, its stages are whole mma k-steps, and
    the last pass over the warps has a thread for each (point, axis)."""
    inst = _bp_instances()
    assert set(inst) == set(ffl.BP_TILES)
    threads = _const(FUSED, "THREADS")
    for (bp, ct), (wm, hc) in inst.items():
        wn = threads // 32 // wm
        assert bp % (16 * wm) == 0 and ct % (8 * wn) == 0
        assert hc % 8 == 0 and 2 * bp <= threads


def test_entry_points_take_the_plans():
    def names(text, fn):
        m = re.search(r"int %s\(([^)]*)\)" % fn, text)
        return [p.split()[-1] for p in m.group(1).split(",")]

    assert names(BASIS, "st_spatial_basis_fwd")[-5:] == [
        "tile_p", "cpt", "threads", "lanes", "stream"]
    bp = names(FUSED, "st_fused_first_layer_bwd_points")
    assert bp[5:7] == ["dcoords", "ws"]
    assert bp[-4:] == ["tile_n", "tile_k", "slabs", "stream"]
    entry = _entry(FUSED, "st_fused_first_layer_bwd_points")
    assert "slab_sum_kernel" in entry            # several k-slabs: summed


def test_bwd_points_source_is_truncating_3xtf32():
    body = re.search(r"bwd_points_kernel\(const float\*.*?\n}\n",
                     _code(FUSED), re.S).group(0)
    assert "split_tf32_trunc(" in body and "split_tf32(" not in body
    assert body.count("mma_3xtf32(") == 1
    assert "cp_async_commit" in body and "atomic" not in body


# ---------------------------------------------------------------------------
# The d-coords kernel's arithmetic and order of sums, mirrored in numpy
# ---------------------------------------------------------------------------

def _dphi(r, basis):
    f = np.float32
    if basis == "wendland":
        om = f(1) - r
        om2 = om * om
        v = f(-(56.0 / 3.0)) * r * (f(5) * r + f(1)) * om2 * om2 * om
        return np.where(r >= 1, f(0), v).astype(f)
    if basis == "gaussian":
        return (-r * np.exp(f(-0.5) * r * r)).astype(f)
    return np.where(r <= 1, f(-1), f(0)).astype(f)


def _mirror_bwd_points(coords, centers, inv_bw, w, g, basis):
    """d coords as bwd_points_kernel forms it: gw by truncating 3xTF32; the
    chain per pair in float32; each thread's sum over its n-tiles and the
    two columns of a fragment, the 4 lanes of a row as a butterfly, the
    warps along centers in order; then the k-slabs in order."""
    f = np.float32
    n, k, h = coords.shape[0], centers.shape[0], w.shape[1]
    bp, ct = ffl.bwd_points_tile(n, k, h)
    wm, _ = _bp_instances()[(bp, ct)]
    wn = _const(FUSED, "THREADS") // 32 // wm
    nt = ct // 8 // wn
    slabs = ffl.bwd_points_slabs(n, k, h)
    gw = _product_3xtf32_trunc(g, np.ascontiguousarray(w.T)).astype(f)
    dx = coords[:, None, 0] - centers[None, :, 0]
    dy = coords[:, None, 1] - centers[None, :, 1]
    d2 = dx * dx + dy * dy
    d = np.sqrt(np.maximum(d2, f(1e-24)))
    gphi = gw * _dphi(d * inv_bw[None], basis)
    coef = np.where(d2 >= f(1e-24), gphi * inv_bw[None] / d, f(0))
    out = []
    for part in (coef * dx, coef * dy):                   # (n, k) float32
        pad = np.zeros((n, slabs * ct), dtype=f)
        pad[:, :k] = part
        # center j of a slab = 8 (wn NT + nt) + 2 tq + u
        x = pad.reshape(n, slabs, wn, nt, 4, 2)
        thread = np.zeros((n, slabs, wn, 4), dtype=f)
        for i in range(nt):
            for u in range(2):
                thread += x[:, :, :, i, :, u]
        lanes = ((thread[..., 0] + thread[..., 1])
                 + (thread[..., 2] + thread[..., 3]))   # (n, slabs, wn)
        block = lanes[:, :, 0].copy()
        for wi in range(1, wn):
            block += lanes[:, :, wi]
        total = block[:, 0].copy()
        for s in range(1, slabs):
            total += block[:, s]
        out.append(total)
    return np.stack(out, axis=1)


def _points_inputs(seed, n, k, h, zero_distance):
    rng = np.random.default_rng(seed)
    coords = rng.uniform(size=(n, 2)).astype(np.float32)
    centers = rng.uniform(size=(k, 2)).astype(np.float32)
    if zero_distance:
        centers[:3] = coords[:3]
    bw = rng.uniform(0.1, 0.8, size=k).astype(np.float32)
    w = (0.1 * rng.normal(size=(k, h))).astype(np.float32)
    g = (rng.normal(size=(n, h)) / n).astype(np.float32)
    return coords, centers, bw, w, g


@pytest.mark.parametrize("basis", ["wendland", "gaussian", "triangular"])
@pytest.mark.parametrize("n,k,h,zero", [(300, 227, 64, False),
                                        (200, 106, 48, True),
                                        (77, 37, 19, False)])
def test_bwd_points_mirror_matches_plain_and_jax(n, k, h, zero, basis):
    """(300, 227, 64) takes 4 k-slabs, (200, 106, 48) 2 with centers on
    data points, (77, 37, 19) one with H % 4 != 0."""
    try:
        from jax.experimental.pallas import tpu as pltpu
    except ImportError:
        pytest.skip("pallas tpu backend unavailable")
    from st_dadk_tpu.ops.pallas_fused import fused_spatial_first_layer

    coords, centers, bw, w, g = _points_inputs(n + k + h, n, k, h, zero)
    cal = ffl.CALIBRATION_FACTORS[basis]
    inv_bw = (1.0 / (torch.as_tensor(bw) * cal)).numpy()
    got = _mirror_bwd_points(coords, centers, inv_bw, w, g, basis)
    assert np.all(np.isfinite(got))
    plain = ffl.plain_bwd_points(
        *(torch.as_tensor(a) for a in (coords, centers, inv_bw, w, g)),
        ffl.BASIS_IDS[basis]).numpy()
    np.testing.assert_allclose(got, plain, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax.grad(lambda s: jnp.sum(fused_spatial_first_layer(
            s, jnp.asarray(centers), jnp.asarray(bw), jnp.asarray(w),
            basis) * jnp.asarray(g)))(jnp.asarray(coords)))
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=GRAD_ATOL)


# ---------------------------------------------------------------------------
# time_kernels: the current signatures and the source variants
# ---------------------------------------------------------------------------

def test_time_kernels_signatures_are_the_wrappers():
    from st_dadk_tpu_torch import time_kernels as tk
    typed = {nm: (p, i) for nm, p, i in ffl._SIGNATURES + sbk._SIGNATURES}
    for entry, sig in tk.CURRENT_SIGNATURES.items():
        assert typed[entry] == sig, entry
    assert set(tk.PREVIOUS_SIGNATURES) == set(tk.CURRENT_SIGNATURES)


@pytest.mark.parametrize("variant", sorted(
    __import__("st_dadk_tpu_torch.time_kernels",
               fromlist=["VARIANTS"]).VARIANTS))
def test_time_kernels_variant_text_occurs_once(variant, tmp_path):
    from st_dadk_tpu_torch import time_kernels as tk
    entry, fname, text, repl = tk.VARIANTS[variant]
    tk._copy(CSRC, tmp_path / variant, (fname, text, repl))
    edited = (tmp_path / variant / fname).read_text()
    assert repl in edited and text not in edited
    assert tk.LIBS[entry] == Path(fname).stem
