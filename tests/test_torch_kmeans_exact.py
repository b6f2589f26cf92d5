"""The port's exact size-constrained k-means (st_dadk_tpu_torch.ops.
kmeans_exact, the solver of `spatial_init_method: kmeans_exact`): the cases
of tests/test_kmeans_exact.py against the port, with its native transport
solver built from native/transport.cpp by g++; the port's
`kmeans_constrained` against the JAX package's, bit for bit, with both on
their native solvers and both on the LP; the native solver against the LP
(its plain version); and the init method, single and batched, against the
JAX package's."""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from st_dadk_tpu.ops import init_centers as ji
from st_dadk_tpu.ops import kmeans_exact as jk
from st_dadk_tpu_torch.ops import _build
from st_dadk_tpu_torch.ops import init_centers as ti
from st_dadk_tpu_torch.ops import kmeans_exact as tk
from st_dadk_tpu_torch.ops.kmeans_exact import (auction_assign_balanced,
                                                balanced_caps,
                                                constrained_assignment,
                                                kmeans_constrained,
                                                transport_assign,
                                                transport_assign_native)
from torch_threads import worker_threads  # noqa: F401


def _sites(seed, u, reps):
    """u distinct sites, each repeated `reps` times (the duplicate-site
    layout of training coords)."""
    rng = np.random.default_rng(seed)
    return np.repeat(rng.uniform(size=(u, 2)), reps, axis=0)


# -- tests/test_kmeans_exact.py's cases on the port -----------------------------

def test_auction_matches_brute_force():
    rng = np.random.default_rng(1)
    for trial in range(25):
        n, m = 9, 3
        cost = rng.integers(0, 25, size=(n, m)).astype(np.float64)
        caps = balanced_caps(n, m)
        col = auction_assign_balanced(cost, caps)
        got = cost[np.arange(n), col].sum()
        best = min(cost[np.arange(n), np.asarray(a)].sum()
                   for a in itertools.product(range(m), repeat=n)
                   if np.all(np.bincount(np.asarray(a), minlength=m) == caps))
        assert got == best, (trial, got, best)
        assert np.array_equal(np.bincount(col, minlength=m), caps)


def test_auction_matches_lp_midsize():
    from scipy import sparse
    from scipy.optimize import linprog

    rng = np.random.default_rng(0)
    n, k = 200, 6
    X, C = rng.uniform(size=(n, 2)), rng.uniform(size=(k, 2))
    cost = ((X[:, None] - C[None]) ** 2).sum(-1)
    caps = balanced_caps(n, k)
    col = constrained_assignment(cost, caps)
    nv = n * k
    A_row = sparse.csr_matrix(
        (np.ones(nv), (np.repeat(np.arange(n), k), np.arange(nv))),
        shape=(n, nv))
    A_col = sparse.csr_matrix(
        (np.ones(nv), (np.tile(np.arange(k), n), np.arange(nv))),
        shape=(k, nv))
    res = linprog(cost.ravel(), A_eq=sparse.vstack([A_row, A_col]),
                  b_eq=np.concatenate([np.ones(n), caps]),
                  bounds=(0, None), method="highs")
    assert res.status == 0
    assert np.array_equal(np.bincount(col, minlength=k), caps)
    assert cost[np.arange(n), col].sum() <= res.fun + n * 1e-7


def test_exact_equal_sizes_and_determinism():
    rng = np.random.default_rng(3)
    X = rng.uniform(size=(500, 2))
    centers, labels = kmeans_constrained(X, 7, n_init=2, max_iter=15)
    sizes = np.bincount(labels, minlength=7)
    q, r = divmod(500, 7)
    assert sizes.min() == q and sizes.max() == q + 1
    assert (sizes == q + 1).sum() == r
    assert centers.min() >= X.min() - 1e-9
    assert centers.max() <= X.max() + 1e-9
    c2, l2 = kmeans_constrained(X, 7, n_init=2, max_iter=15)
    np.testing.assert_array_equal(l2, labels)
    np.testing.assert_array_equal(c2, centers)


def test_better_than_random_partition():
    rng = np.random.default_rng(5)
    X = np.concatenate([rng.normal([0.2, 0.2], 0.05, (150, 2)),
                        rng.normal([0.8, 0.8], 0.05, (150, 2))])
    centers, labels = kmeans_constrained(X, 2, n_init=1, max_iter=10)
    inertia = ((X - centers[labels]) ** 2).sum()
    rand_labels = np.zeros(300, np.int64)
    rand_labels[rng.permutation(300)[150:]] = 1
    rand_centers = np.stack([X[rand_labels == j].mean(0) for j in (0, 1)])
    assert inertia < 0.2 * ((X - rand_centers[rand_labels]) ** 2).sum()


def test_dedup_transport_matches_point_level_auction():
    rng = np.random.default_rng(11)
    sites = rng.uniform(size=(20, 2))
    X = np.repeat(sites, 15, axis=0)
    _, labels = kmeans_constrained(X, 6, n_init=1, max_iter=10)
    sizes = np.bincount(labels, minlength=6)
    assert sizes.min() == sizes.max() == 50
    centers = rng.uniform(size=(6, 2))
    cost = ((X[:, None] - centers[None]) ** 2).sum(-1)
    caps = balanced_caps(len(X), 6)
    col = constrained_assignment(cost, caps)
    point_cost = cost[np.arange(len(X)), col].sum()
    cost_u = ((sites[:, None] - centers[None]) ** 2).sum(-1)
    for solve in (lambda: transport_assign(cost_u, np.full(20, 15), caps),
                  lambda: transport_assign_native(cost_u, np.full(20, 15),
                                                  caps)):
        flows = solve()[0]
        np.testing.assert_array_equal(flows.sum(axis=1), np.full(20, 15))
        np.testing.assert_array_equal(flows.sum(axis=0), caps)
        assert abs(float((flows * cost_u).sum()) - point_cost) \
            <= 1e-6 * max(point_cost, 1.0)


def test_column_generation_matches_full_lp():
    rng = np.random.default_rng(21)
    u, k = 220, 90                              # 19800 arcs > 16384
    sites = np.concatenate([rng.normal(0, .1, (u // 2, 2)),
                            rng.normal(1, .1, (u - u // 2, 2))])
    centers = np.concatenate([rng.normal(0, .3, (k // 2, 2)),
                              rng.normal(1, .3, (k - k // 2, 2))])
    cost_u = ((sites[:, None] - centers[None]) ** 2).sum(-1)
    supplies = rng.integers(1, 6, size=u)
    caps = balanced_caps(int(supplies.sum()), k)
    flows, _ = transport_assign(cost_u, supplies, caps, arcs_per_row=8)
    full, y, z = tk._solve_restricted(cost_u, supplies, caps,
                                      np.repeat(np.arange(u), k),
                                      np.tile(np.arange(k), u))
    opt = float((full * cost_u).sum())
    assert abs(float((flows * cost_u).sum()) - opt) <= 1e-7 * max(opt, 1.0)
    red = cost_u - y[:, None] - z[None, :]
    assert np.abs(red[full > 0]).max() < 1e-6 and red.min() > -1e-6


def test_native_simplex_matches_lp_cold_and_warm():
    """The native solver (its library built from native/transport.cpp)
    against the LP, its plain version: cold, then warm-started across
    drifting costs as Lloyd iterations call it."""
    rng = np.random.default_rng(13)
    u, k = 40, 9
    supplies = rng.integers(1, 12, size=u)
    caps = balanced_caps(int(supplies.sum()), k)
    cost_u = rng.uniform(size=(u, k))
    state = None
    for it in range(6):
        if it:
            cost_u = np.abs(cost_u + 0.1 * rng.standard_normal((u, k)))
        flows, state = transport_assign_native(cost_u, supplies, caps,
                                               state=state)
        assert flows.min() >= 0
        np.testing.assert_array_equal(flows.sum(axis=1), supplies)
        np.testing.assert_array_equal(flows.sum(axis=0), caps)
        ref, _ = transport_assign(cost_u, supplies, caps)
        np.testing.assert_allclose(float((flows * cost_u).sum()),
                                   float((ref * cost_u).sum()), rtol=1e-9)


def test_native_simplex_optimal_basis_at_zero_pivots():
    rng = np.random.default_rng(7)
    u, k = 25, 6
    supplies = rng.integers(1, 9, size=u)
    caps = balanced_caps(int(supplies.sum()), k)
    cost_u = np.ascontiguousarray(rng.uniform(size=(u, k)), np.float64)
    _, (flow, basis) = transport_assign_native(cost_u, supplies, caps)
    status = tk._native_transport_lib().stdadk_transport_simplex(
        u, k, cost_u, np.ascontiguousarray(supplies, np.int64),
        np.ascontiguousarray(caps, np.int64), flow, basis, 1, 0)
    assert status == 0


def test_seeding_survives_degenerate_potential():
    X = _sites(13, 5, 40)                       # 200 points, 5 unique
    centers, labels = kmeans_constrained(X, 8, n_init=1, max_iter=5)
    assert np.isfinite(centers).all()
    sizes = np.bincount(labels, minlength=8)
    assert sizes.sum() == 200 and sizes.max() <= 26


def test_library_builds_from_the_source_not_the_committed_one():
    lib = tk._native_transport_lib()
    path = _build.host_library_path("transport")
    assert path.exists() and path.parent.name == "host"
    assert lib._name == str(path)
    with pytest.raises(ValueError, match="solver"):
        kmeans_constrained(_sites(0, 10, 4), 3, solver="scipy")


# -- bit for bit the JAX package's --------------------------------------------------

@pytest.mark.parametrize("k", [9, 25])
def test_kmeans_constrained_bitwise_jax_native_and_lp(monkeypatch, k):
    """Same float64 points: the port's centers and labels are the JAX
    package's bit for bit, native solver against native solver and LP
    against LP (JAX takes its LP where its library is missing); and the
    native plan equals the LP's here (integer costs, one optimum)."""
    X = _sites(k, 100, 30)
    cn, ln = kmeans_constrained(X, k)
    cj, lj = jk.kmeans_constrained(X, k)
    np.testing.assert_array_equal(cn, cj)
    np.testing.assert_array_equal(ln, lj)
    cl, ll = kmeans_constrained(X, k, solver="lp")
    monkeypatch.setattr(jk, "_native_transport_lib", lambda: None)
    cjl, ljl = jk.kmeans_constrained(X, k)
    np.testing.assert_array_equal(cl, cjl)
    np.testing.assert_array_equal(ll, ljl)
    np.testing.assert_array_equal(cn, cl)


def test_point_level_path_bitwise_jax():
    """Distinct points (no duplicate-site path): the auction, bit for bit."""
    X = np.random.default_rng(8).uniform(size=(180, 2))
    for a, b in zip(kmeans_constrained(X, 6, n_init=2, max_iter=8),
                    jk.kmeans_constrained(X, 6, n_init=2, max_iter=8)):
        np.testing.assert_array_equal(a, b)


def test_init_kmeans_exact_single_matches_jax():
    """`init_spatial_centers('kmeans_exact')`: the subsample from the
    lane's RandomState (JAX: the global stream at the same state), the
    exact k-means a resolution, the bandwidth rule (k = 1 included)."""
    coords = _sites(4, 60, 40).astype(np.float32)          # 2400 points
    ks = [1, 9, 16]
    np.random.seed(11)
    cj, bj = ji.init_spatial_centers("kmeans_exact", ks, coords,
                                     subsample=1000)
    rng = np.random.RandomState(11)
    ct, bt = ti.init_spatial_centers("kmeans_exact", ks, coords, rng=rng,
                                     subsample=1000)
    assert ct.shape == (26, 2) and ct.dtype == np.float32
    np.testing.assert_array_equal(ct, cj)
    np.testing.assert_array_equal(bt, bj)
    # the stream continues where the JAX package's global one does
    assert rng.randint(1 << 30) == np.random.randint(1 << 30)


def test_init_kmeans_exact_batch_matches_jax_batch():
    coords = [_sites(s, 50, 30).astype(np.float32) for s in (5, 6)]
    states = []
    for i in range(2):
        np.random.seed(77 + i)
        states.append(np.random.get_state())
    keys = jnp.stack([jax.random.PRNGKey(i) for i in range(2)])
    want = ji.init_spatial_centers_batch("kmeans_exact", [9], coords, keys,
                                         rng_states=states, subsample=800)
    rngs = []
    for st in states:
        r = np.random.RandomState()
        r.set_state(st)
        rngs.append(r)
    got = ti.init_spatial_centers_batch("kmeans_exact", [9], coords,
                                        rngs=rngs, subsample=800)
    for (c1, b1), (c2, b2) in zip(want, got):
        np.testing.assert_array_equal(c2, c1)
        np.testing.assert_array_equal(b2, b1)
