"""Port parity: the spherical GMM EM of st_dadk_tpu_torch.ops.init_centers
fed the JAX package's own k-means++ seeds, against st_dadk_tpu's
gmm_spherical (the seeds come from torch.Generator in the port, so they are
handed across to compare the EM itself)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from st_dadk_tpu.ops import init_centers as ji
from st_dadk_tpu_torch.ops import init_centers as ti

# Both EMs run in float32 with reductions in another order, over ~20-60
# tol-stopped iterations; the gap measured at k = 9, 25, 81 on these points
# is <= 7e-6 in means and <= 3e-6 in sigmas. 5e-5 bounds it with margin and
# stays far below what a different seed moves (~1/sqrt(k)).
TOL = 5e-5


def _points(seed=0, n=2000):
    rng = np.random.default_rng(seed)
    blobs = rng.uniform(0.1, 0.9, size=(6, 2))
    x = blobs[rng.integers(0, 6, n)] + rng.normal(scale=0.05, size=(n, 2))
    return np.clip(x, 0, 1).astype(np.float32)


@pytest.mark.parametrize("k", [9, 25])
def test_em_from_jax_seeds_matches_jax(k):
    X = _points()
    key = jax.random.PRNGKey(3)
    means_j, sig_j = ji.gmm_spherical(key, jnp.asarray(X), k)
    # the seeds JAX's n_init=3 restarts start from (gmm_spherical's em_once)
    seeds = [torch.tensor(np.asarray(ji.kmeans_plus_plus(sk, jnp.asarray(X),
                                                         k)))
             for sk in jax.random.split(key, 3)]
    means_t, sig_t = ti.gmm_spherical(torch.as_tensor(X), k, seeds=seeds)
    np.testing.assert_allclose(means_t.numpy(), np.asarray(means_j), atol=TOL)
    np.testing.assert_allclose(sig_t.numpy(), np.asarray(sig_j), atol=TOL)


def test_seeding_survives_fewer_distinct_points_than_centers():
    """Site-wise designs can leave fewer distinct training sites than
    centers; seeding then picks index 0 once every distance is zero, as
    jax.random.choice does, instead of failing."""
    X = np.repeat(_points(1, 7), 30, axis=0)
    g = torch.Generator().manual_seed(0)
    seeds = ti.kmeans_plus_plus(torch.as_tensor(X), 12, g)
    assert seeds.shape == (12, 2)
    assert len(np.unique(seeds.numpy(), axis=0)) == 7
    centers, bw = ti.init_spatial_centers("gmm", [4, 9], X, generator=g,
                                          device="cpu")
    assert centers.shape == (13, 2) and np.all(np.isfinite(bw))


def test_bandwidth_floor_and_uniform_path():
    X = _points(2, 500)
    g = torch.Generator().manual_seed(1)
    centers, bw = ti.init_spatial_centers("gmm", [9, 25], X, generator=g,
                                          device="cpu")
    assert centers.shape == (34, 2)
    assert np.all(bw[:9] >= 0.25 * ti.uniform_bandwidth_for(9) - 1e-7)
    assert np.all(bw[9:] >= 0.25 * ti.uniform_bandwidth_for(25) - 1e-7)
    for a, b in zip(ti.init_spatial_centers("uniform", [25, 81]),
                    ji.init_spatial_centers("uniform", [25, 81])):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(NotImplementedError):
        ti.init_spatial_centers("kmeans_balanced", [9], X, generator=g)
