"""Port parity: the spherical GMM EM of st_dadk_tpu_torch.ops.init_centers
fed the JAX package's own k-means++ seeds, against st_dadk_tpu's
gmm_spherical (the seeds come from torch.Generator in the port, so they are
handed across to compare the EM itself); and the batched init of a batch of
lanes against the lane-by-lane init."""
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
    with pytest.raises(NotImplementedError, match="kmeans_exact"):
        ti.init_spatial_centers("kmeans_exact", [9], X, generator=g)


# -- the batched init of a batch of lanes ----------------------------------------

# the EM takes every sum a run at a time and lanes share an EM batch only
# where their subsamples have one size, so a lane's result in a batch is the
# single init's bit for bit


def _lane_by_lane(coords, ks, cap):
    out, iters = [], []
    for i, c in enumerate(coords):
        stats = {}
        out.append(ti.init_spatial_centers(
            "gmm", ks, c, generator=torch.Generator().manual_seed(i),
            device="cpu", rng=np.random.RandomState(i), subsample=cap,
            stats=stats))
        iters.append(np.concatenate(stats["em_iterations"], axis=1)[0])
    return out, np.asarray(iters)


@pytest.mark.parametrize("sizes", [(1500, 1500, 1500), (1500, 700, 1000)],
                         ids=["equal", "unequal"])
def test_batched_init_equals_the_lane_by_lane_init(sizes):
    """Each lane of `init_spatial_centers_batch` gets the centers and
    bandwidths `init_spatial_centers` gives it alone, from its own generator
    and numpy stream, bit for bit and in the same EM iterations; lanes whose
    subsamples differ in size run in EM batches of their own. The streams
    end where the single init leaves them."""
    coords = [_points(i, n) for i, n in enumerate(sizes)]
    ks, cap = [9, 16], 900
    want, want_iters = _lane_by_lane(coords, ks, cap)
    gens = [torch.Generator().manual_seed(i) for i in range(3)]
    rngs = [np.random.RandomState(i) for i in range(3)]
    stats = {}
    got = ti.init_spatial_centers_batch("gmm", ks, coords, gens, rngs, "cpu",
                                        cap, None, stats=stats)
    for (c1, b1), (c2, b2) in zip(want, got):
        assert c2.shape == (25, 2) and c2.dtype == np.float32
        np.testing.assert_array_equal(c2, c1)
        np.testing.assert_array_equal(b2, b1)
    np.testing.assert_array_equal(
        np.concatenate(stats["em_iterations"], axis=1), want_iters)
    assert stats["seed_seconds"] > 0 and stats["em_seconds"] > 0
    for i in range(3):       # the next draw of every stream is the single's
        g, r = torch.Generator().manual_seed(i), np.random.RandomState(i)
        ti.init_spatial_centers("gmm", ks, coords[i], generator=g,
                                device="cpu", rng=r, subsample=cap)
        assert torch.rand(1, generator=g) == torch.rand(1, generator=gens[i])
        assert r.randint(1 << 30) == rngs[i].randint(1 << 30)


@pytest.mark.parametrize("k", [9, 25])
def test_batched_em_from_jax_seeds_matches_jax(k):
    """`_em` over 2 lanes x 3 restarts from the JAX package's own
    seeds against its gmm_spherical a lane (as the single-lane test above),
    with the converged-run mask read every few iterations."""
    Xs = [_points(s) for s in (0, 5)]
    keys = [jax.random.PRNGKey(3), jax.random.PRNGKey(4)]
    seeds = torch.stack([torch.stack([
        torch.tensor(np.asarray(ji.kmeans_plus_plus(sk, jnp.asarray(X), k)))
        for sk in jax.random.split(key, 3)]) for X, key in zip(Xs, keys)])
    Xb = torch.as_tensor(np.stack(Xs))
    means, sigmas, ll, iters = ti._em(Xb, seeds)
    assert means.shape == (2, 3, k, 2) and iters.min() >= 2
    assert len(set(iters.flatten().tolist())) > 1     # runs stop on their own
    best = torch.argmax(ll, dim=1)
    for i, (X, key) in enumerate(zip(Xs, keys)):
        means_j, sig_j = ji.gmm_spherical(key, jnp.asarray(X), k)
        np.testing.assert_allclose(means[i, best[i]].numpy(),
                                   np.asarray(means_j), atol=TOL)
        np.testing.assert_allclose(sigmas[i, best[i]].numpy(),
                                   np.asarray(sig_j), atol=TOL)


def test_batched_init_uniform_chunks_and_refusals():
    X = [_points(2, 400), _points(3, 400)]
    grid = ti.init_spatial_centers("uniform", [25, 81])
    for c, b in ti.init_spatial_centers_batch("uniform", [25, 81], [None] * 3):
        np.testing.assert_array_equal(c, grid[0])
        np.testing.assert_array_equal(b, grid[1])
    gens = lambda: [torch.Generator().manual_seed(i) for i in range(2)]
    whole = ti.init_spatial_centers_batch("gmm", [9], X, gens(), None, "cpu")
    old = ti.EM_BATCH_ELEMENTS
    ti.EM_BATCH_ELEMENTS = 1          # one lane a chunk of the EM
    try:
        parts = ti.init_spatial_centers_batch("gmm", [9], X, gens(), None,
                                              "cpu")
    finally:
        ti.EM_BATCH_ELEMENTS = old
    for (c1, b1), (c2, b2) in zip(whole, parts):
        np.testing.assert_array_equal(c2, c1)
        np.testing.assert_array_equal(b2, b1)
    with pytest.raises(NotImplementedError, match="kmeans_exact"):
        ti.init_spatial_centers_batch("kmeans_exact", [9], X, gens())
    with pytest.raises(ValueError, match="generators"):
        ti.init_spatial_centers_batch("gmm", [9], X, gens()[:1])
    with pytest.raises(ValueError, match="train_coords"):
        ti.init_spatial_centers_batch("gmm", [9], [None, None], gens())
