"""Port parity: the numpy CSV ingest and the stand-in field
(st_dadk_tpu_torch.dataio against st_dadk_tpu.dataio)."""
import numpy as np
import pytest

from st_dadk_tpu.dataio.kaust import load_kaust_csv_single as jax_load
from st_dadk_tpu_torch.dataio import synthetic
from st_dadk_tpu_torch.dataio.kaust import load_kaust_csv_single as torch_load
from torch_threads import worker_threads  # noqa: F401


def _write(path, rows, header="x,y,t,z"):
    path.write_text("\n".join([header] + [",".join(map(str, r)) for r in rows]))
    return path


@pytest.mark.parametrize("normalize", [False, True])
def test_loader_matches_jax(tmp_path, normalize):
    """Unsorted sites, rows out of order and missing (t, s) cells."""
    rng = np.random.default_rng(0)
    sites = rng.uniform(size=(7, 2)).round(4)
    rows = [(sites[s, 0], sites[s, 1], t, round(float(rng.normal()), 5))
            for t in (3, 1, 2, 5) for s in rng.permutation(7)
            if not (t == 2 and s == 4)]
    path = _write(tmp_path / "f.csv", rows)
    zj, cj, mj = jax_load(path, normalize=normalize, verbose=False)
    zt, ct, mt = torch_load(path, normalize=normalize, verbose=False)
    np.testing.assert_array_equal(cj, ct)
    np.testing.assert_array_equal(np.isnan(zj), np.isnan(zt))
    np.testing.assert_allclose(zt, zj, rtol=0, atol=1e-6, equal_nan=True)
    assert (mt["T"], mt["S"]) == (mj["T"], mj["S"]) == (5, 7)
    assert mt["z_mean"] == pytest.approx(mj["z_mean"], rel=1e-6)


def test_loader_spatial_only(tmp_path):
    path = _write(tmp_path / "s.csv", [(0.1, 0.2, 1.5), (0.3, 0.4, -2.0)],
                  header="x,y,z")
    zj, cj, _ = jax_load(path, normalize=False, verbose=False)
    zt, ct, _ = torch_load(path, normalize=False, verbose=False)
    np.testing.assert_array_equal(zt, zj)
    np.testing.assert_array_equal(ct, cj)


def test_standin_field_round_trip(tmp_path):
    path = synthetic.write_standin_csv(tmp_path / "standin.csv", n_sites=30,
                                       T=6, seed=1)
    z, coords, meta = torch_load(path, normalize=False, verbose=False)
    assert z.shape == (6, 30) and coords.shape == (30, 2)
    assert not np.isnan(z).any()
    assert np.all((coords >= 0) & (coords <= 1))
    # deterministic from the seed
    again = synthetic.write_standin_csv(tmp_path / "again.csv", n_sites=30,
                                        T=6, seed=1)
    assert again.read_text() == path.read_text()
