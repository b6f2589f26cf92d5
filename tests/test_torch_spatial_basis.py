"""Port parity: the materialised spatial basis phi (N, k) and its gradients
(st_dadk_tpu_torch.ops.spatial_basis_kernels) against the JAX package's
Pallas kernels (`spatial_basis_embed_pallas`, run in interpret mode as
tests/test_pallas_basis.py runs it on the CPU) and the jnp oracle.

On the CPU the kernel wrappers take their plain PyTorch versions; the CUDA
kernels themselves are checked against those on the card by chip_smoke.py.
Bars: phi atol 2e-6, gradients atol 5e-4 / rtol 5e-3
(tests/test_pallas_basis.py:46,63)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from st_dadk_tpu.ops.basis import spatial_basis_embed as jnp_embed
from st_dadk_tpu_torch.ops import spatial_basis_kernels as sbk
from torch_threads import worker_threads  # noqa: F401

PHI_ATOL = 2e-6
GRAD_RTOL, GRAD_ATOL = 5e-3, 5e-4
BASES = ["wendland", "gaussian", "triangular"]


@pytest.fixture
def interpret_mode():
    try:
        from jax.experimental.pallas import tpu as pltpu
    except ImportError:
        pytest.skip("pallas tpu backend unavailable")
    with pltpu.force_tpu_interpret_mode():
        yield


def _inputs(seed, n=300, k=130, zero_distance=False):
    """Shapes that are not tile multiples (the Pallas tiles are 256 x 128);
    with `zero_distance`, centers lie exactly on data points."""
    rng = np.random.default_rng(seed)
    coords = rng.uniform(size=(n, 2)).astype(np.float32)
    centers = rng.uniform(size=(k, 2)).astype(np.float32)
    if zero_distance:
        centers[:5] = coords[:5]
    bw = rng.uniform(0.1, 0.8, size=(k,)).astype(np.float32)
    g = rng.normal(size=(n, k)).astype(np.float32)
    return coords, centers, bw, g


def _jax_value_and_grads(embed, coords, centers, bw, g, basis):
    args = tuple(jnp.asarray(a) for a in (coords, centers, bw))
    G = jnp.asarray(g)
    out = np.asarray(embed(*args, basis))
    grads = jax.grad(lambda s, c, b: jnp.sum(embed(s, c, b, basis) * G),
                     argnums=(0, 1, 2))(*args)
    return out, [np.asarray(x) for x in grads]


def _port_value_and_grads(coords, centers, bw, g, basis):
    s, c, b = (torch.as_tensor(a).requires_grad_(True)
               for a in (coords, centers, bw))
    out = sbk.spatial_basis_embed_kernel(s, c, b, basis)
    grads = torch.autograd.grad(torch.sum(out * torch.as_tensor(g)), (s, c, b))
    return out.detach().numpy(), [x.numpy() for x in grads]


def _assert_close(got, want):
    (out_p, grads_p), (out_j, grads_j) = got, want
    assert out_p.shape == out_j.shape
    np.testing.assert_allclose(out_p, out_j, rtol=0, atol=PHI_ATOL)
    for a, b, name in zip(grads_p, grads_j,
                          ("dcoords", "dcenters", "dbandwidths")):
        assert np.all(np.isfinite(a)), name
        np.testing.assert_allclose(a, b, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("zero_distance", [False, True])
@pytest.mark.parametrize("basis", BASES)
def test_matches_jax_pallas_embed(interpret_mode, basis, zero_distance):
    """phi and its three gradients against spatial_basis_embed_pallas, the
    custom VJP around the three Pallas kernels this module ports."""
    from st_dadk_tpu.ops.pallas_basis import spatial_basis_embed_pallas
    args = _inputs(1, zero_distance=zero_distance)
    want = _jax_value_and_grads(spatial_basis_embed_pallas, *args, basis)
    _assert_close(_port_value_and_grads(*args, basis), want)


@pytest.mark.parametrize("zero_distance", [False, True])
@pytest.mark.parametrize("basis", BASES)
def test_matches_jnp_embed(basis, zero_distance):
    """phi and its gradients against the jnp oracle: the route a ragged-k
    lane takes in JAX, where every Pallas route is off."""
    args = _inputs(2, zero_distance=zero_distance)
    want = _jax_value_and_grads(jnp_embed, *args, basis)
    _assert_close(_port_value_and_grads(*args, basis), want)


@pytest.mark.parametrize("basis", BASES)
def test_plain_gradients_match_analytic_chain(basis):
    """plain_bwd_points / plain_bwd_centers (autograd) equal the chain the
    CUDA kernels evaluate, in numpy float64:
        d s = sum_j g phi'(r) inv_bw (s - c) / d,
        d c = -sum_n g phi'(r) inv_bw (s - c) / d,
        d inv_bw = sum_n g phi'(r) d."""
    coords, centers, bw, g = _inputs(3, n=64, k=12)
    inv_bw = (1.0 / bw).astype(np.float32)
    bid = sbk.BASIS_IDS[basis]
    t = [torch.as_tensor(a) for a in (coords, centers, inv_bw, g)]
    ds = sbk.plain_bwd_points(*t, bid).numpy()
    dc, dib = (x.numpy() for x in sbk.plain_bwd_centers(*t, bid))
    x, c = coords.astype(np.float64), centers.astype(np.float64)
    dx = x[:, None, 0] - c[None, :, 0]
    dy = x[:, None, 1] - c[None, :, 1]
    d = np.sqrt(np.maximum(dx * dx + dy * dy, 1e-24))
    r = d * inv_bw[None].astype(np.float64)
    dphi = {"wendland": np.where(r < 1, -(56 / 3) * r * (5 * r + 1)
                                 * (1 - r) ** 5, 0.0),
            "gaussian": -r * np.exp(-0.5 * r * r),
            "triangular": np.where(r <= 1, -1.0, 0.0)}[basis]
    gphi = g.astype(np.float64) * dphi
    coef = gphi * inv_bw[None] / d
    np.testing.assert_allclose(ds[:, 0], (coef * dx).sum(1), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(ds[:, 1], (coef * dy).sum(1), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(dc[:, 0], -(coef * dx).sum(0), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(dc[:, 1], -(coef * dy).sum(0), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(dib, (gphi * d).sum(0), rtol=1e-5, atol=1e-6)


def test_masked_columns_get_exactly_zero_gradients():
    """phi * mask (a ragged-k lane) leaves the junk centers and bandwidths
    with gradients that are exactly zero, so they never move in a fit."""
    coords, centers, bw, g = _inputs(4, n=50, k=20)
    mask = torch.as_tensor((np.arange(20) < 13).astype(np.float32))
    c = torch.as_tensor(centers).requires_grad_(True)
    b = torch.as_tensor(bw).requires_grad_(True)
    phi = sbk.spatial_basis_embed_kernel(torch.as_tensor(coords), c, b,
                                         "wendland") * mask
    dc, db = torch.autograd.grad(torch.sum(phi * torch.as_tensor(g)), (c, b))
    assert torch.all(dc[13:] == 0) and torch.all(db[13:] == 0)
    assert torch.any(dc[:13] != 0) and torch.any(db[:13] != 0)


def test_cpu_wrappers_take_the_plain_version_and_count_nothing():
    coords, centers, bw, g = (torch.as_tensor(a) for a in
                              _inputs(5, n=33, k=9))
    sbk.reset_launch_counts()
    inv_bw = 1.0 / bw
    for bid in range(3):
        torch.testing.assert_close(
            sbk.spatial_basis_fwd(coords, centers, inv_bw, bid),
            sbk.plain_fwd(coords, centers, inv_bw, bid), rtol=0, atol=0)
        torch.testing.assert_close(
            sbk.spatial_basis_bwd_points(coords, centers, inv_bw, g, bid),
            sbk.plain_bwd_points(coords, centers, inv_bw, g, bid), rtol=0,
            atol=0)
        dc, dib = sbk.spatial_basis_bwd_centers(coords, centers, inv_bw, g,
                                                bid)
        assert dc.shape == (9, 2) and dib.shape == (9,)
    assert sbk.launch_counts() == {"spatial_basis_fwd": 0,
                                   "spatial_basis_bwd_points": 0,
                                   "spatial_basis_bwd_centers": 0}


def test_mixed_devices_raise():
    coords, centers, bw, _ = (torch.as_tensor(a) for a in
                              _inputs(6, n=5, k=3))
    with pytest.raises(ValueError, match="mixed devices"):
        sbk.spatial_basis_fwd(coords, centers.to("meta"), 1.0 / bw, 0)


# ---------------------------------------------------------------------------
# The lane axis and the per-lane column mask (phi forward and d centers)
# ---------------------------------------------------------------------------

LANES = 3
# real widths of the lanes of a padded batch: one lane fully real
K_REAL = (41, 67, 77)


def _lane_inputs(seed, n=90, k=77, zero_distance=False):
    """`_inputs` of LANES seeds stacked on a lane axis, k not a tile
    multiple, and each lane's column mask (1 on its K_REAL leading columns)."""
    per = [_inputs(seed + 10 * m, n=n, k=k, zero_distance=zero_distance)
           for m in range(LANES)]
    coords, centers, bw, g = (np.stack(x) for x in zip(*per))
    mask = (np.arange(k)[None] < np.asarray(K_REAL)[:, None]).astype(
        np.float32)
    return coords, centers, bw, g, mask


@pytest.mark.parametrize("zero_distance", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("basis", BASES)
def test_lane_form_matches_vmapped_jax(basis, masked, zero_distance):
    """Lane phi (x mask) and its d centers / d bandwidths against jax.vmap
    of the jnp oracle times the mask and its jax.grad: phi atol 2e-6, grads
    rtol 5e-3 / atol 5e-4 (the bars of the two-dimensional form)."""
    coords, centers, bw, g, mask = _lane_inputs(
        7, zero_distance=zero_distance)
    mk = jnp.asarray(mask if masked else np.ones_like(mask))

    def embed(s, c, b):
        phi = jax.vmap(lambda s1, c1, b1: jnp_embed(s1, c1, b1, basis))(
            s, c, b)
        return phi * mk[:, None, :]

    args = tuple(jnp.asarray(a) for a in (coords, centers, bw))
    want = np.asarray(embed(*args))
    want_dc, want_db = jax.grad(
        lambda s, c, b: jnp.sum(embed(s, c, b) * jnp.asarray(g)),
        argnums=(1, 2))(*args)

    c = torch.as_tensor(centers).requires_grad_(True)
    b = torch.as_tensor(bw).requires_grad_(True)
    phi = sbk.spatial_basis_embed_kernel(
        torch.as_tensor(coords), c, b, basis,
        mask=torch.as_tensor(mask) if masked else None)
    dc, db = torch.autograd.grad(torch.sum(phi * torch.as_tensor(g)), (c, b))
    assert phi.shape == (LANES, 90, 77)
    np.testing.assert_allclose(phi.detach().numpy(), want, rtol=0,
                               atol=PHI_ATOL)
    np.testing.assert_allclose(dc.numpy(), np.asarray(want_dc),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)
    np.testing.assert_allclose(db.numpy(), np.asarray(want_db),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)
    if masked:
        for m, kr in enumerate(K_REAL):
            assert torch.all(phi[m, :, kr:] == 0)
            assert torch.all(dc[m, kr:] == 0) and torch.all(db[m, kr:] == 0)


@pytest.mark.parametrize("basis", BASES)
def test_lane_form_equals_the_two_dimensional_form_a_lane(basis):
    """Lanes share no operand: lane m of the lane call equals the
    two-dimensional call on lane m's operands exactly on the real columns,
    and is exactly 0 on the masked ones; M = 1 without a mask is the
    two-dimensional call."""
    coords, centers, bw, g, mask = (torch.as_tensor(a) for a in
                                    _lane_inputs(8))
    bid = sbk.BASIS_IDS[basis]
    inv_bw = 1.0 / bw
    phi = sbk.spatial_basis_fwd(coords, centers, inv_bw, bid, mask)
    dc, dib = sbk.spatial_basis_bwd_centers(coords, centers, inv_bw, g, bid,
                                            mask)
    for m, kr in enumerate(K_REAL):
        phi2 = sbk.spatial_basis_fwd(coords[m], centers[m], inv_bw[m], bid)
        dc2, dib2 = sbk.spatial_basis_bwd_centers(coords[m], centers[m],
                                                  inv_bw[m], g[m], bid)
        assert torch.equal(phi[m, :, :kr], phi2[:, :kr])
        assert torch.equal(dc[m, :kr], dc2[:kr])
        assert torch.equal(dib[m, :kr], dib2[:kr])
        assert torch.all(phi[m, :, kr:] == 0)
        assert torch.all(dc[m, kr:] == 0) and torch.all(dib[m, kr:] == 0)
        one = sbk.spatial_basis_fwd(coords[m:m + 1], centers[m:m + 1],
                                    inv_bw[m:m + 1], bid)
        assert torch.equal(one[0], phi2)
        # a (k,) mask on the two-dimensional call is the lane's row
        assert torch.equal(
            sbk.spatial_basis_fwd(coords[m], centers[m], inv_bw[m], bid,
                                  mask[m]), phi[m])


def test_masked_phi_is_a_select_not_a_product():
    """A masked column is 0 even where its phi is not finite."""
    coords, centers, bw, _, mask = (torch.as_tensor(a) for a in
                                    _lane_inputs(9, n=12, k=77))
    inv_bw = 1.0 / bw
    inv_bw[0, 50] = float("nan")                  # a junk column of lane 0
    phi = sbk.spatial_basis_fwd(coords, centers, inv_bw, 0, mask)
    assert torch.all(phi[0, :, 41:] == 0) and torch.isfinite(phi).all()


def test_lane_launch_refusals():
    """More lanes than a grid dimension holds raise before any launch; d
    coords of the lane form, or under a mask, raises; a padded mask of the
    wrong shape raises on a CUDA-shaped check."""
    from st_dadk_tpu_torch.ops import _launch
    from st_dadk_tpu_torch.ops import fused_first_layer as ffl
    with pytest.raises(ValueError, match="exceed"):
        ffl._lanes("spatial_basis_fwd", (ffl.MAX_GRID_YZ + 1,))
    assert ffl._lanes("spatial_basis_bwd_centers", (ffl.MAX_GRID_YZ,)) == \
        ffl.MAX_GRID_YZ
    # one lane's N chooses the plans and the slab count, whatever M
    assert sbk.basis_bwd_centers_workspace(512, 227, "cpu", (4,)).shape == (
        4, sbk.basis_bwd_centers_slabs(512, 227), 227, 3)
    coords, centers, bw, g, mask = (torch.as_tensor(a) for a in
                                    _lane_inputs(10, n=20, k=77))
    with pytest.raises(ValueError, match="shape"):
        sbk._mask_ptr(mask[:, :5].contiguous(), (LANES,), 77)
    assert sbk._mask_ptr(None, (LANES,), 77) is None
    lead, n, k = _launch.check_basis_lanes("x", coords, centers, 1.0 / bw, 0)
    assert (lead, n, k) == ((LANES,), 20, 77)
    for kw, s in ((dict(), coords), (dict(mask=mask[0]), coords[0])):
        s = s.clone().requires_grad_(True)
        c = centers if s.dim() == 3 else centers[0]
        b = bw if s.dim() == 3 else bw[0]
        phi = sbk.spatial_basis_embed_kernel(s, c, b, "wendland", **kw)
        with pytest.raises(NotImplementedError, match="d-coords"):
            phi.sum().backward()
