"""Port parity: spatial phi and temporal psi of st_dadk_tpu_torch.ops.basis
against the jnp oracle st_dadk_tpu.ops.basis, same numpy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from st_dadk_tpu.ops import basis as jb
from st_dadk_tpu_torch.ops import basis as tb
from torch_threads import worker_threads  # noqa: F401

PHI_ATOL = 2e-6   # the bar of tests/test_pallas_basis.py:46


def _inputs(seed=0, n=200, k=106):
    rng = np.random.default_rng(seed)
    coords = rng.uniform(size=(n, 2)).astype(np.float32)
    centers = rng.uniform(size=(k, 2)).astype(np.float32)
    bw = rng.uniform(0.1, 0.8, size=(k,)).astype(np.float32)
    return coords, centers, bw


@pytest.mark.parametrize("basis", ["wendland", "gaussian", "triangular"])
def test_spatial_embed_matches_jnp(basis):
    coords, centers, bw = _inputs()
    want = np.asarray(jb.spatial_basis_embed(jnp.asarray(coords),
                                             jnp.asarray(centers),
                                             jnp.asarray(bw), basis))
    got = tb.spatial_basis_embed(torch.as_tensor(coords),
                                 torch.as_tensor(centers),
                                 torch.as_tensor(bw), basis).numpy()
    assert got.shape == (200, 106)
    np.testing.assert_allclose(got, want, rtol=0, atol=PHI_ATOL)


@pytest.mark.parametrize("basis", ["wendland", "gaussian", "triangular"])
def test_inverse_bandwidth_form_matches_jnp(basis):
    """basis_matrix (r = dist * inv_bw, the kernels' form) equals the jnp
    embed with r = dist / (bw * calibration)."""
    coords, centers, bw = _inputs(seed=1)
    inv_bw = 1.0 / (torch.as_tensor(bw) * tb.CALIBRATION_FACTORS[basis])
    got = tb.basis_matrix(torch.as_tensor(coords), torch.as_tensor(centers),
                          inv_bw, basis).numpy()
    want = np.asarray(jb.spatial_basis_embed(jnp.asarray(coords),
                                             jnp.asarray(centers),
                                             jnp.asarray(bw), basis))
    np.testing.assert_allclose(got, want, rtol=0, atol=PHI_ATOL)


def test_temporal_embed_matches_jnp():
    rng = np.random.default_rng(2)
    t = rng.uniform(size=(300, 1)).astype(np.float32)
    c, bw = jb.temporal_grid_centers([10, 15, 45])
    want = np.asarray(jb.temporal_basis_embed(jnp.asarray(t), jnp.asarray(c),
                                              jnp.asarray(bw)))
    got = tb.temporal_basis_embed(torch.as_tensor(t), torch.as_tensor(c),
                                  torch.as_tensor(bw)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=PHI_ATOL)


def test_grid_initializers_equal():
    for a, b in zip(jb.uniform_grid_centers([25, 81, 121]),
                    tb.uniform_grid_centers([25, 81, 121])):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jb.temporal_grid_centers([10, 15, 45]),
                    tb.temporal_grid_centers([10, 15, 45])):
        np.testing.assert_array_equal(a, b)
    assert tb.CALIBRATION_FACTORS == jb.CALIBRATION_FACTORS
    assert tb.BASIS_IDS == jb.BASIS_IDS
    for k in (4, 25, 121):
        assert tb.uniform_bandwidth_for(k) == jb.uniform_bandwidth_for(k)


def test_unknown_basis_raises():
    with pytest.raises(ValueError):
        tb.apply_basis(torch.zeros(3), "cubic")
