"""Port parity: losses, penalties and numpy scores
(st_dadk_tpu_torch.ops.losses against st_dadk_tpu.ops.losses)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from st_dadk_tpu.ops import losses as jl
from st_dadk_tpu_torch.ops import losses as tl
from torch_threads import worker_threads  # noqa: F401

ATOL = 1e-6   # float32 reductions of ~100 terms in another order


def _data(seed=0, n=96, q=5):
    rng = np.random.default_rng(seed)
    preds = rng.normal(size=(n, q)).astype(np.float32)
    y = rng.normal(size=(n, 1)).astype(np.float32)
    w = (rng.uniform(size=n) > 0.3).astype(np.float32)
    return preds, y, w


@pytest.mark.parametrize("weighted", [False, True])
def test_multi_quantile_loss(weighted):
    preds, y, w = _data()
    q = np.array([0.05, 0.25, 0.5, 0.75, 0.95], np.float32)
    want = float(jl.multi_quantile_loss(jnp.asarray(preds), jnp.asarray(y),
                                        jnp.asarray(q),
                                        jnp.asarray(w) if weighted else None))
    got = float(tl.multi_quantile_loss(torch.as_tensor(preds),
                                       torch.as_tensor(y), torch.as_tensor(q),
                                       torch.as_tensor(w) if weighted else None))
    assert abs(got - want) <= ATOL


@pytest.mark.parametrize("weighted", [False, True])
def test_mse_and_quantile_loss(weighted):
    preds, y, w = _data(1, q=1)
    jw = jnp.asarray(w) if weighted else None
    tw = torch.as_tensor(w) if weighted else None
    assert abs(float(jl.mse_loss(jnp.asarray(preds), jnp.asarray(y), jw))
               - float(tl.mse_loss(torch.as_tensor(preds), torch.as_tensor(y),
                                   tw))) <= ATOL
    for tau in (0.1, 0.5, 0.9):
        a = float(jl.quantile_loss(jnp.asarray(preds), jnp.asarray(y), tau, jw))
        b = float(tl.quantile_loss(torch.as_tensor(preds), torch.as_tensor(y),
                                   tau, tw))
        assert abs(a - b) <= ATOL


@pytest.mark.parametrize("power", [1, 2])
def test_non_crossing_penalties(power):
    preds, _, w = _data(2)
    a = float(jl.non_crossing_penalty(jnp.asarray(preds), "mean", power,
                                      weights=jnp.asarray(w)))
    b = float(tl.non_crossing_penalty(torch.as_tensor(preds), "mean", power,
                                      weights=torch.as_tensor(w)))
    assert abs(a - b) <= ATOL
    delta = np.random.default_rng(3).normal(size=(5, 17)).astype(np.float32)
    assert abs(float(jl.p_nc_delta_penalty(jnp.asarray(delta)))
               - float(tl.p_nc_delta_penalty(torch.as_tensor(delta)))) <= ATOL


def test_numpy_scores_equal():
    preds, y, _ = _data(4)
    q = [0.05, 0.25, 0.5, 0.75, 0.95]
    assert tl.compute_crps_multi_quantile(preds, y, q) == \
        jl.compute_crps_multi_quantile(preds, y, q)
    assert tl.compute_crps_multi_quantile(preds, y, q, weights=[1, 2, 3, 2, 1]) \
        == jl.compute_crps_multi_quantile(preds, y, q, weights=[1, 2, 3, 2, 1])
    assert tl.check_loss_np(preds[:, 0], y[:, 0], 0.3) == \
        jl.check_loss_np(preds[:, 0], y[:, 0], 0.3)
