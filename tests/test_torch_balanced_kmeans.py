"""Port parity of the 'kmeans_balanced' and 'random_site' inits of
st_dadk_tpu_torch.ops.init_centers: the Lloyd steps with a log-domain
Sinkhorn plan fed the JAX package's own k-means++ seeds (the port's seeds
come from torch.Generator, so they are handed across to compare the fit
itself), the restart each keeps, the bandwidth rule and the numpy draws of
the random sites; and the batched init of a batch of lanes against the
lane-by-lane init."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from st_dadk_tpu.ops import init_centers as ji
from st_dadk_tpu_torch.config import ExperimentConfig
from st_dadk_tpu_torch.ops import init_centers as ti
from st_dadk_tpu_torch.train.experiment import ExperimentSetup

# Both run 50 Lloyd steps of 40 Sinkhorn iterations in float32 with their
# reductions in another order; the gap measured on these points is <= 1e-6.
# 1e-5 is the bar the port is held to and still far below what another
# seed moves a center (~1/sqrt(k)).
ATOL = 1e-5
# the batched init against the lane-by-lane one: every reduction of `_bkm`
# sums a run alike whatever shares its batch, so the bar is 0 (the JAX
# package holds its own batched init at rtol 1e-4 / atol 1e-5,
# tests/test_init_centers.py:198-202)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The Sinkhorn loop runs thousands of small ops; on a shared CPU,
    intra-op threads only add overhead to them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _points(seed=0, n=2000):
    rng = np.random.default_rng(seed)
    blobs = rng.uniform(0.1, 0.9, size=(6, 2))
    x = blobs[rng.integers(0, 6, n)] + rng.normal(scale=0.05, size=(n, 2))
    return np.clip(x, 0, 1).astype(np.float32)


def _jax_seeds(key, X, k, n_init=3):
    """The seeds of JAX balanced_kmeans' n_init restarts (its fit_once)."""
    return torch.stack([torch.tensor(np.asarray(
        ji.kmeans_plus_plus(sk, jnp.asarray(X), k)))
        for sk in jax.random.split(key, n_init)])


@pytest.mark.parametrize("n,k", [(500, 4), (500, 9), (2000, 25)])
def test_lloyd_sinkhorn_from_jax_seeds_matches_jax(n, k):
    X = _points(0, n)
    key = jax.random.PRNGKey(7)
    want = np.asarray(ji.balanced_kmeans(key, jnp.asarray(X), k))
    seeds = _jax_seeds(key, X, k)
    centers, cost = ti._bkm(torch.as_tensor(X)[None], seeds[None])
    centers, cost = centers[0].numpy(), cost[0].numpy()
    best = int(np.argmin(cost))
    # the restart JAX kept is the one whose centers it returned
    kept = [r for r in range(3) if np.abs(centers[r] - want).max() <= ATOL]
    assert kept and kept[0] == best, (cost, kept)
    np.testing.assert_allclose(centers[best], want, rtol=0, atol=ATOL)
    got = ti.balanced_kmeans(torch.as_tensor(X), k, seeds=seeds).numpy()
    np.testing.assert_array_equal(got, centers[best])
    # balanced: each cluster holds about n / k of the points' mass
    assert np.all(np.isfinite(cost)) and np.all(cost > 0)


def test_restarts_tied_to_float32_precision_pick_as_jax_picks():
    """At (500, 4) and (500, 9) two restarts reach costs equal to about
    6 digits; the restart kept is still JAX's (the first of equals)."""
    for n, k in [(500, 4), (500, 9)]:
        X = _points(0, n)
        seeds = _jax_seeds(jax.random.PRNGKey(7), X, k)
        _, cost = ti._bkm(torch.as_tensor(X)[None], seeds[None])
        c = np.sort(cost[0].numpy())
        assert (c[1] - c[0]) / c[0] < 2e-6, c
    # exactly equal costs: identical restarts; the first is kept, as
    # jnp.argmin keeps it
    X = _points(1, 300)
    s = _jax_seeds(jax.random.PRNGKey(2), X, 5, n_init=2)
    seeds = torch.stack([s[1], s[0], s[1]])
    centers, cost = ti._bkm(torch.as_tensor(X)[None], seeds[None])
    assert cost[0, 0] == cost[0, 2]
    got = ti.balanced_kmeans(torch.as_tensor(X), 5, seeds=seeds)
    assert int(torch.argmin(cost[0])) in (0, 1)
    if cost[0, 0] <= cost[0, 1]:
        np.testing.assert_array_equal(got.numpy(), centers[0, 0].numpy())


def test_fewer_distinct_sites_than_centers():
    """6 distinct sites with temporal duplicates and k = 9 > 6: duplicate
    centers, a bandwidth floor of 0.25x the uniform one, nothing NaN."""
    rng = np.random.default_rng(4)
    sites = rng.uniform(size=(6, 2)).astype(np.float32)
    X = np.repeat(sites, 50, axis=0)
    g = torch.Generator().manual_seed(3)
    centers, bw = ti.init_spatial_centers("kmeans_balanced", [4, 9], X,
                                          generator=g, device="cpu")
    assert centers.shape == (13, 2) and bw.shape == (13,)
    assert np.all(np.isfinite(centers)) and np.all(np.isfinite(bw))
    assert np.all(bw[:4] >= np.float32(0.25 * ti.uniform_bandwidth_for(4)))
    assert np.all(bw[4:] >= np.float32(0.25 * ti.uniform_bandwidth_for(9)))
    # and the JAX package's bandwidths of the same centers are the same
    np.testing.assert_array_equal(ti._nn_bandwidths(centers[4:]),
                                  ji._nn_bandwidths(centers[4:]))
    # from JAX's seeds too: the restarts split a site's mass between two
    # centers, so their costs tie and JAX's centers are one of several
    # equivalent layouts; what holds is that nothing is NaN
    got = ti.balanced_kmeans(torch.as_tensor(X), 9, seeds=_jax_seeds(
        jax.random.PRNGKey(5), X, 9)).numpy()
    assert np.all(np.isfinite(got))


@pytest.mark.parametrize("case", ["spread", "duplicates", "one", "two"])
def test_nn_bandwidths_equal_jax(case):
    rng = np.random.default_rng(6)
    c = {"spread": rng.uniform(size=(25, 2)),
         "duplicates": np.repeat(rng.uniform(size=(3, 2)), 3, axis=0),
         "one": rng.uniform(size=(1, 2)),
         "two": rng.uniform(size=(2, 2))}[case].astype(np.float32)
    got, want = ti._nn_bandwidths(c), ji._nn_bandwidths(c)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,ks", [(500, [4, 1, 9]), (5, [4, 9]),
                                  (300, [25, 81])])
def test_random_site_equals_jax_under_the_same_numpy_state(n, ks):
    """JAX draws from the global numpy stream, the port from the lane's
    RandomState: the same Mersenne Twister, so the same state gives the same
    sites (with replacement when k > n) and bandwidths (k == 1 takes the
    uniform bandwidth of the first resolution)."""
    X = _points(2, n)
    np.random.seed(11)
    want = ji.init_spatial_centers("random_site", ks, X)
    got = ti.random_site(X, ks, np.random.RandomState(11))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.random.seed(11)
    via_init = ti.init_spatial_centers("random_site", ks, X,
                                       rng=np.random.RandomState(11))
    for a, b in zip(via_init, want):
        np.testing.assert_array_equal(a, b)


def _streams(n_lanes):
    return ([torch.Generator().manual_seed(100 + i) for i in range(n_lanes)],
            [np.random.RandomState(200 + i) for i in range(n_lanes)])


@pytest.mark.parametrize("method", ["kmeans_balanced", "random_site"])
def test_batched_init_of_lanes_of_two_sizes_against_lane_by_lane(method):
    """Three lanes, two subsample sizes (one not a multiple of the row
    alignment): every lane of the batch is bit for bit the lane alone."""
    ks = [4, 9]
    coords = [_points(10, 700), _points(11, 700), _points(12, 451)]
    gens, rngs = _streams(3)
    stats = {}
    batch = ti.init_spatial_centers_batch(method, ks, coords, gens, rngs,
                                          "cpu", stats=stats)
    gens, rngs = _streams(3)
    for i, (c, b) in enumerate(batch):
        st = {}
        c1, b1 = ti.init_spatial_centers(method, ks, coords[i],
                                         generator=gens[i], device="cpu",
                                         rng=rngs[i], stats=st)
        np.testing.assert_array_equal(c, c1)
        np.testing.assert_array_equal(b, b1)
        assert c.shape == (13, 2) and np.all(b > 0)
        if method == "kmeans_balanced":
            assert [int(r[i]) for r in stats["best_restart"]] == \
                [int(r[0]) for r in st["best_restart"]]


def test_balanced_kmeans_chunks_by_its_element_budget(monkeypatch):
    """One lane a chunk gives the lanes' results of the whole batch."""
    ks = [4]
    coords = [_points(20, 300), _points(21, 300)]
    whole = ti.init_spatial_centers_batch("kmeans_balanced", ks, coords,
                                          *_streams(2), "cpu")
    monkeypatch.setattr(ti, "BKM_BATCH_ELEMENTS", 1)
    parts = ti.init_spatial_centers_batch("kmeans_balanced", ks, coords,
                                          *_streams(2), "cpu")
    for (c1, b1), (c2, b2) in zip(whole, parts):
        np.testing.assert_array_equal(c2, c1)
        np.testing.assert_array_equal(b2, b1)


def test_halving_sum():
    """The per-run totals (eps, cost) end in a sum by halving adds; the
    padded points (n = 500 and 2,000 pad to 512 and 2,048) are held to
    JAX above."""
    x = torch.arange(1.0, 8.0).repeat(3, 1)               # 7 columns
    np.testing.assert_array_equal(ti._halving_sum(x).numpy(), [28.0] * 3)
    assert float(ti._halving_sum(torch.ones(2, 1))[0]) == 1.0


def test_data_adaptive_methods_and_the_unported_one(tmp_path):
    assert set(ti.DATA_ADAPTIVE_INIT_METHODS) == {
        "gmm", "random_site", "kmeans_balanced", "kmeans_exact"}
    # kmeans_exact, once refused at set-up, now sets up and initialises
    # from the exact k-means of the setup's training coords
    rng = np.random.default_rng(2)
    sites = rng.uniform(size=(20, 2)).round(5)
    (tmp_path / "toy.csv").write_text("\n".join(
        ["x,y,t,z"] + [f"{x},{y},{t},{np.sin(3 * x) + t / 10:.5f}"
                       for t in range(1, 7) for x, y in sites]))
    cfg = ExperimentConfig.from_dict(dict(
        spatial_init_method="kmeans_exact", device="cpu",
        data_file=str(tmp_path / "toy.csv"), k_spatial_centers=[4],
        k_temporal_centers=[3], hidden_dims=[8], obs_ratio=0.8))
    setup = ExperimentSetup(cfg, 1, "cpu")
    want = ti.init_spatial_centers(
        "kmeans_exact", [4], setup.train_ps.coords,
        rng=ExperimentSetup(cfg, 1, "cpu", defer_model=True).np_rng)
    np.testing.assert_array_equal(
        setup.model.spatial_centers_init.numpy(), want[0])
    with pytest.raises(ValueError, match="Unknown init_method"):
        ti.init_spatial_centers_batch("kmeans", [4], [_points(0, 50)],
                                      *_streams(1), "cpu")
