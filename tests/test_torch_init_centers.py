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
from torch_threads import worker_threads  # noqa: F401

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
    # kmeans_exact, once refused, runs: the JAX package's centers and
    # bandwidths from the same numpy stream, bit for bit
    np.random.seed(4)
    want = ji.init_spatial_centers("kmeans_exact", [9], X)
    got = ti.init_spatial_centers("kmeans_exact", [9], X, generator=g,
                                  rng=np.random.RandomState(4))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


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
    # kmeans_exact, once refused, runs lane by lane on the host: each lane
    # is its single init
    exact = ti.init_spatial_centers_batch("kmeans_exact", [9], X, gens())
    for x, (c, b) in zip(X, exact):
        for u, v in zip((c, b), ti.init_spatial_centers("kmeans_exact", [9],
                                                        x)):
            np.testing.assert_array_equal(u, v)
    with pytest.raises(ValueError, match="generators"):
        ti.init_spatial_centers_batch("gmm", [9], X, gens()[:1])
    with pytest.raises(ValueError, match="train_coords"):
        ti.init_spatial_centers_batch("gmm", [9], [None, None], gens())


# -- the JAX init knobs: init_em_dtype and init_seed_rounds ---------------------

# The bf16 EM is held to JAX's over a fixed number of EM steps (tol 0), so
# the iteration counts cannot part. JAX runs in a child process with XLA's
# `xla_allow_excess_precision` off: by default the CPU compiler keeps the
# fused variance product `resp * d2_new` in float32 and drops the bf16
# rounding the source writes there, and the port rounds where the source
# does. Measured at k = 9, 25 on two point sets, 2 steps: the port's bf16
# EM is <= 3.2e-6 from JAX's in means and sigmas, while JAX's float32 EM
# is >= 1.2e-5 from JAX's bf16 EM and JAX's bf16 EM with the excess
# precision on is >= 1.4e-5 from it in sigmas. So 6e-6 passes the casts
# where JAX writes them and fails an EM that skips either rounding.
BF16_STEPS = 2
BF16_TOL = 6e-6

_JAX_BF16_EM = """
import sys
import jax, jax.numpy as jnp, numpy as np
from st_dadk_tpu.ops import init_centers as ji
X = np.load(sys.argv[1])
out = {}
for k in (9, 25):
    key = jax.random.PRNGKey(3)
    for dt in ("bfloat16", "float32"):
        m, s = ji.gmm_spherical(key, jnp.asarray(X), k, max_iter=%d, tol=0.0,
                                em_dtype=dt)
        out[f"{dt}_{k}_means"], out[f"{dt}_{k}_sigmas"] = m, s
    out[f"seeds_{k}"] = np.stack([ji.kmeans_plus_plus(sk, jnp.asarray(X), k)
                                  for sk in jax.random.split(key, 3)])
np.savez(sys.argv[2], **{n: np.asarray(v) for n, v in out.items()})
""" % BF16_STEPS


@pytest.fixture(scope="module")
def jax_bf16_em(tmp_path_factory):
    """JAX's bf16 and float32 EMs and their seeds, computed as written."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    d = tmp_path_factory.mktemp("bf16_em")
    np.save(d / "X.npy", _points())
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_allow_excess_precision=false").strip()
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, "-c", _JAX_BF16_EM, str(d / "X.npy"),
         str(d / "em.npz")], cwd=Path(__file__).resolve().parent.parent,
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return dict(np.load(d / "em.npz"))


@pytest.mark.parametrize("k", [9, 25])
def test_bf16_em_from_jax_seeds_matches_jax(k, jax_bf16_em):
    """`init_em_dtype: bfloat16`: the EM's distances and responsibilities
    stored in bf16 where JAX stores them, from JAX's own seeds, over
    BF16_STEPS EM steps; the float32 EM misses the same bar."""
    X = torch.as_tensor(_points())
    seeds = list(torch.as_tensor(jax_bf16_em[f"seeds_{k}"]))
    want = [jax_bf16_em[f"bfloat16_{k}_{n}"] for n in ("means", "sigmas")]
    f32 = [jax_bf16_em[f"float32_{k}_{n}"] for n in ("means", "sigmas")]
    got = ti.gmm_spherical(X, k, seeds=seeds, max_iter=BF16_STEPS, tol=0.0,
                           em_dtype="bfloat16")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=BF16_TOL)
    port_f32 = ti.gmm_spherical(X, k, seeds=seeds, max_iter=BF16_STEPS,
                                tol=0.0)
    for other in (f32, [t.numpy() for t in port_f32]):
        assert max(np.abs(a - w).max() for a, w in zip(other, want)) \
            > BF16_TOL


def test_seed_rounds():
    """`init_seed_rounds`: k - 1 rounds make the exact seeding's draws bit
    for bit; fewer rounds draw several seeds a round from the same
    distribution, all of them points of X."""
    X = torch.as_tensor(_points(1, 600))
    for k in (2, 9):
        exact = ti.kmeans_plus_plus(X, k, torch.Generator().manual_seed(5))
        rounds = ti.kmeans_plus_plus_rounds(X, k,
                                            torch.Generator().manual_seed(5),
                                            rounds=k - 1)
        assert torch.equal(rounds, exact)
    seeds = ti.kmeans_plus_plus_rounds(X, 25, torch.Generator().manual_seed(5),
                                       rounds=4)
    assert seeds.shape == (25, 2)
    assert all(bool((X == s).all(dim=1).any()) for s in seeds)
    g1, g2 = (torch.Generator().manual_seed(0) for _ in range(2))
    a = ti.init_spatial_centers("gmm", [9], X.numpy()[:300], generator=g1,
                                device="cpu", seed_rounds=2)
    b = ti.init_spatial_centers("gmm", [9], X.numpy()[:300], generator=g2,
                                device="cpu")
    assert a[0].shape == b[0].shape == (9, 2)
    assert not np.array_equal(a[0], b[0])


@pytest.mark.parametrize("rounds", [2, 4, 8])
@pytest.mark.parametrize("k", [9, 25])
def test_seed_rounds_match_jax(k, rounds, monkeypatch):
    """`init_seed_rounds` against JAX's `_seed_centers(seed_rounds=R)`:
    JAX's draws are handed across (each `_choice` takes jax.random.choice
    from the next of JAX's split keys, on the port's own probabilities), so
    the round split, the d2 update and the draws with replacement must give
    JAX's seeds bit for bit."""
    X = _points(1, 600)
    key = jax.random.PRNGKey(11)
    want = np.asarray(ji._seed_centers(key, jnp.asarray(X), k,
                                       seed_rounds=rounds))
    calls = []

    def jax_choice(p, generator, size=1):
        nonlocal key
        key, sub = jax.random.split(key)
        shape = () if not calls else (size,)   # the first seed: one draw
        calls.append(size)
        idx = jax.random.choice(sub, p.shape[0], shape=shape,
                                p=jnp.asarray(p.numpy()), replace=True)
        return torch.as_tensor(np.array(idx)).reshape(
            () if size == 1 else (size,))

    monkeypatch.setattr(ti, "_choice", jax_choice)
    got = ti._seed_centers(torch.as_tensor(X), k, torch.Generator(),
                           seed_rounds=rounds)
    base, rem = divmod(k - 1, rounds)
    assert calls == [1] + [base + (r < rem) for r in range(rounds)]
    np.testing.assert_array_equal(got.numpy(), want)
