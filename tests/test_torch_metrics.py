"""The port's copies of the JAX package's numpy utilities against the
originals on the same inputs: `utils/metrics.py` (NaN-masked metrics, the
per-horizon breakdown, distance-binned spatial metrics, the printout),
`utils/covariance.py` (the Matern(nu=1) fit) and `utils/seed.py`."""
import random

import numpy as np
import pytest
import torch

from st_dadk_tpu.utils import covariance as jcov
from st_dadk_tpu.utils import metrics as jm
from st_dadk_tpu_torch.utils import covariance as tcov
from st_dadk_tpu_torch.utils import metrics as tmet
from st_dadk_tpu_torch.utils.seed import set_seed
from torch_threads import worker_threads  # noqa: F401


def _fields(seed=0):
    rng = np.random.default_rng(seed)
    y_true = rng.normal(size=(6, 3, 40, 1))
    y_pred = y_true + rng.normal(0, 0.3, size=y_true.shape)
    y_true[rng.uniform(size=y_true.shape) < 0.1] = np.nan
    y_pred[0, 0, :3] = np.nan
    return y_true, y_pred, rng.uniform(size=(40, 2))


@pytest.mark.parametrize("per_horizon", [False, True])
def test_compute_metrics_as_jax(per_horizon):
    y_true, y_pred, _ = _fields()
    assert tmet.compute_metrics(y_true, y_pred, per_horizon) == \
        jm.compute_metrics(y_true, y_pred, per_horizon)
    got = tmet.compute_metrics(y_true, y_pred, per_horizon)
    assert ("rmse_per_horizon" in got) == per_horizon
    yt = y_true.ravel()
    yp = y_pred.ravel()
    ok = ~(np.isnan(yt) | np.isnan(yp))
    assert got["rmse"] == pytest.approx(
        np.sqrt(np.mean((yt[ok] - yp[ok]) ** 2)))


def test_compute_spatial_metrics_and_print_as_jax(capsys):
    y_true, y_pred, coords = _fields(1)
    got = tmet.compute_spatial_metrics(y_true, y_pred, coords, n_bins=4)
    assert got == jm.compute_spatial_metrics(y_true, y_pred, coords,
                                             n_bins=4)
    assert len(got["bin_centers"]) <= 4
    m = tmet.compute_metrics(y_true, y_pred, per_horizon=True)
    tmet.print_metrics(m, "test")
    mine = capsys.readouterr().out
    jm.print_metrics(m, "test")
    assert mine == capsys.readouterr().out and "RMSE per horizon" in mine


def test_matern_fit_as_jax():
    rng = np.random.default_rng(2)
    h = rng.uniform(0, 0.6, 20000)
    prod = tcov.matern1_correlation(h, 0.8, 0.12) + rng.normal(0, 0.05,
                                                               h.size)
    np.testing.assert_array_equal(tcov.matern1_correlation(h[:50], 0.8, 0.1),
                                  jcov.matern1_correlation(h[:50], 0.8, 0.1))
    got = tcov.fit_matern1(h, prod)
    assert got == jcov.fit_matern1(h, prod)
    assert got[0] == pytest.approx(0.8, abs=0.05)
    assert got[1] == pytest.approx(0.12, abs=0.02)


def test_set_seed_seeds_every_host_stream():
    g = set_seed(7)
    a = (random.random(), np.random.rand(), torch.rand(1).item(),
         torch.rand(1, generator=g).item())
    g = set_seed(7)
    b = (random.random(), np.random.rand(), torch.rand(1).item(),
         torch.rand(1, generator=g).item())
    assert a == b
    assert a[3] == torch.rand(1, generator=torch.Generator().manual_seed(7)
                              ).item()
