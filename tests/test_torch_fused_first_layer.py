"""Port parity: the fused first layer h = phi(coords) @ W_s and its gradients
(st_dadk_tpu_torch.ops.fused_first_layer) against the JAX package.

On the CPU the kernel wrappers take their plain PyTorch versions; the CUDA
kernels themselves are checked against those on the card by chip_smoke.py.
Bars: values atol 1e-4, gradients rtol 2e-4 / atol 2e-5
(tests/test_pallas_fused.py:40,92)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from st_dadk_tpu.ops.basis import spatial_basis_embed as jnp_embed
from st_dadk_tpu_torch.ops import fused_first_layer as ffl
from torch_threads import worker_threads  # noqa: F401

FWD_ATOL = 1e-4
GRAD_RTOL, GRAD_ATOL = 2e-4, 2e-5


def _inputs(seed, n, k, h, zero_distance=False):
    rng = np.random.default_rng(seed)
    coords = rng.uniform(size=(n, 2)).astype(np.float32)
    centers = rng.uniform(size=(k, 2)).astype(np.float32)
    if zero_distance:
        centers[:3] = coords[:3]          # centers exactly on data points
    bw = rng.uniform(0.1, 0.8, size=(k,)).astype(np.float32)
    w = (rng.normal(size=(k, h)) * 0.1).astype(np.float32)
    g = rng.normal(size=(n, h)).astype(np.float32)
    return coords, centers, bw, w, g


def _port_value_and_grads(coords, centers, bw, w, g, basis):
    c = torch.as_tensor(centers).requires_grad_(True)
    b = torch.as_tensor(bw).requires_grad_(True)
    ww = torch.as_tensor(w).requires_grad_(True)
    out = ffl.fused_spatial_first_layer(torch.as_tensor(coords), c, b, ww,
                                        basis)
    loss = torch.sum(out * torch.as_tensor(g))
    grads = torch.autograd.grad(loss, (c, b, ww))
    return out.detach().numpy(), [x.numpy() for x in grads]


def _jax_value_and_grads(fn, coords, centers, bw, w, g):
    G = jnp.asarray(g)
    out = np.asarray(fn(jnp.asarray(coords), jnp.asarray(centers),
                        jnp.asarray(bw), jnp.asarray(w)))
    grads = jax.grad(lambda c, b, ww: jnp.sum(
        fn(jnp.asarray(coords), c, b, ww) * G), argnums=(0, 1, 2))(
        jnp.asarray(centers), jnp.asarray(bw), jnp.asarray(w))
    return out, [np.asarray(x) for x in grads]


def _assert_close(got, want):
    (out_p, grads_p), (out_j, grads_j) = got, want
    np.testing.assert_allclose(out_p, out_j, rtol=0, atol=FWD_ATOL)
    for a, b, name in zip(grads_p, grads_j, ("dcenters", "dbandwidths", "dW")):
        assert np.all(np.isfinite(a)), name
        np.testing.assert_allclose(a, b, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)


def test_matches_jax_fused_kernel_in_interpret_mode():
    """Against the JAX custom-VJP kernel itself, run as its own tests run it
    on the CPU (Pallas interpret mode), at its test's shapes."""
    try:
        from jax.experimental.pallas import tpu as pltpu
    except ImportError:
        pytest.skip("pallas tpu backend unavailable")
    from st_dadk_tpu.ops.pallas_fused import fused_spatial_first_layer

    args = _inputs(2, 200, 106, 48)
    with pltpu.force_tpu_interpret_mode():
        want = _jax_value_and_grads(
            lambda c, ce, b, w: fused_spatial_first_layer(c, ce, b, w,
                                                          "wendland"), *args)
    _assert_close(_port_value_and_grads(*args, "wendland"), want)


@pytest.mark.parametrize("basis", ["wendland", "gaussian", "triangular"])
def test_matches_jnp_embed_matmul(basis):
    """Against spatial_basis_embed(...) @ w with autodiff, at N, k, H that
    are not tile multiples."""
    args = _inputs(3, 77, 37, 19)
    want = _jax_value_and_grads(
        lambda c, ce, b, w: jnp_embed(c, ce, b, basis) @ w, *args)
    _assert_close(_port_value_and_grads(*args, basis), want)


@pytest.mark.parametrize("basis", ["wendland", "gaussian", "triangular"])
def test_zero_distance_gradients_finite(basis):
    args = _inputs(4, 50, 20, 8, zero_distance=True)
    want = _jax_value_and_grads(
        lambda c, ce, b, w: jnp_embed(c, ce, b, basis) @ w, *args)
    _assert_close(_port_value_and_grads(*args, basis), want)


@pytest.mark.parametrize("zero_distance", [False, True])
@pytest.mark.parametrize("basis", ["wendland", "gaussian", "triangular"])
def test_coords_gradient_matches_jax_fused_kernel(basis, zero_distance):
    """d coords through the fused layer (the port of _bwd_pts_kernel)
    against JAX's fused_spatial_first_layer in interpret mode, with centers
    exactly on data points in the zero-distance case."""
    try:
        from jax.experimental.pallas import tpu as pltpu
    except ImportError:
        pytest.skip("pallas tpu backend unavailable")
    from st_dadk_tpu.ops.pallas_fused import fused_spatial_first_layer

    coords, centers, bw, w, g = _inputs(5, 130, 70, 24, zero_distance)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax.grad(lambda s: jnp.sum(fused_spatial_first_layer(
            s, jnp.asarray(centers), jnp.asarray(bw), jnp.asarray(w),
            basis) * jnp.asarray(g)))(jnp.asarray(coords)))
    s = torch.as_tensor(coords).requires_grad_(True)
    out = ffl.fused_spatial_first_layer(s, torch.as_tensor(centers),
                                        torch.as_tensor(bw),
                                        torch.as_tensor(w), basis)
    (got,) = torch.autograd.grad(torch.sum(out * torch.as_tensor(g)), (s,))
    assert np.all(np.isfinite(got.numpy()))
    np.testing.assert_allclose(got.numpy(), want, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)


def test_cpu_wrappers_take_the_plain_version_and_count_nothing():
    coords, centers, bw, w, g = (torch.as_tensor(a) for a in
                                 _inputs(6, 33, 9, 5))
    ffl.reset_launch_counts()
    inv_bw = 1.0 / bw
    torch.testing.assert_close(
        ffl.fused_first_layer_fwd(coords, centers, inv_bw, w, 0),
        ffl.plain_fwd(coords, centers, inv_bw, w, 0), rtol=0, atol=0)
    torch.testing.assert_close(
        ffl.fused_first_layer_bwd_w(coords, centers, inv_bw, g, 0),
        ffl.plain_bwd_w(coords, centers, inv_bw, g, 0), rtol=0, atol=0)
    dc, dib = ffl.fused_first_layer_bwd_centers(coords, centers, inv_bw, w,
                                                g, 0)
    assert dc.shape == (9, 2) and dib.shape == (9,)
    torch.testing.assert_close(
        ffl.fused_first_layer_bwd_points(coords, centers, inv_bw, w, g, 0),
        ffl.plain_bwd_points(coords, centers, inv_bw, w, g, 0), rtol=0,
        atol=0)
    assert ffl.launch_counts() == {"fused_first_layer_fwd": 0,
                                   "fused_first_layer_bwd_w": 0,
                                   "fused_first_layer_bwd_centers": 0,
                                   "fused_first_layer_bwd_points": 0}


def test_plain_centers_gradient_matches_analytic_chain():
    """plain_bwd_centers (autograd) equals the kernel's analytic chain
    d c = -sum_n gw phi'(r) inv_bw (s - c)/d, d inv_bw = sum_n gw phi'(r) d,
    written here in numpy float64 (the formula the CUDA kernel evaluates)."""
    coords, centers, bw, w, g = _inputs(7, 64, 12, 6)
    inv_bw = (1.0 / bw).astype(np.float32)
    dc, dib = ffl.plain_bwd_centers(*(torch.as_tensor(a) for a in
                                      (coords, centers, inv_bw, w, g)), 0)
    x = coords.astype(np.float64)
    c = centers.astype(np.float64)
    dx = x[:, None, 0] - c[None, :, 0]
    dy = x[:, None, 1] - c[None, :, 1]
    d = np.sqrt(np.maximum(dx * dx + dy * dy, 1e-24))
    r = d * inv_bw[None].astype(np.float64)
    dphi = np.where(r < 1, -(56 / 3) * r * (5 * r + 1) * (1 - r) ** 5, 0.0)
    gphi = (g.astype(np.float64) @ w.astype(np.float64).T) * dphi
    coef = gphi * inv_bw[None] / d
    np.testing.assert_allclose(dc.numpy()[:, 0], -(coef * dx).sum(0),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)
    np.testing.assert_allclose(dc.numpy()[:, 1], -(coef * dy).sum(0),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)
    np.testing.assert_allclose(dib.numpy(), (gphi * d).sum(0),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_mixed_devices_raise():
    coords, centers, bw, w, _ = (torch.as_tensor(a) for a in
                                 _inputs(8, 5, 3, 2))
    with pytest.raises(ValueError, match="mixed devices"):
        ffl.fused_first_layer_fwd(coords, centers.to("meta"), 1.0 / bw, w, 0)
