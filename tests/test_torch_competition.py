"""The competition data layout on the port (`dataio/kaust.py`,
`dataio/competition.py`) against the JAX package's `dataio/kaust.py`:
`load_kaust_csv` on a train/test pair (equal arrays, site index and
metadata), `sample_observed_sites` (equal indices from the same seed),
`predictions_to_csv` (the parsed submissions equal), and the family the
smoke run cuts from a full field. Everything here is exact: the same
parsed doubles and the same float32 arithmetic."""
import numpy as np
import pandas as pd
import pytest

from st_dadk_tpu.dataio import kaust as jk
from st_dadk_tpu_torch.dataio import kaust as tk
from st_dadk_tpu_torch.dataio.competition import write_competition_family
from torch_threads import worker_threads  # noqa: F401


def _field(S=30, T=12, seed=0, spatial_only=False):
    rng = np.random.default_rng(seed)
    sites = rng.uniform(size=(S, 2)).round(5)
    rows = []
    for t in range(1, T + 1):
        for s in range(S):
            z = np.sin(3 * sites[s, 0]) + 0.1 * t + rng.normal(0, 0.1)
            rows.append((sites[s, 0], sites[s, 1], t, round(z, 6)))
    df = pd.DataFrame(rows, columns=["x", "y", "t", "z"])
    return df.drop(columns="t") if spatial_only else df


def _pair(tmp_path, spatial_only=False, extra_test_sites=0, seed=0):
    """A train/test pair: train t <= 9 with rows dropped, test t > 9 at
    every site (with `extra_test_sites` only in the test file), no z."""
    df = _field(seed=seed, spatial_only=spatial_only)
    rng = np.random.default_rng(seed + 1)
    if spatial_only:
        train, test = df.iloc[:20], df.iloc[20:][["x", "y"]]
    else:
        train = df[df.t <= 9]
        train = train[rng.random(len(train)) > 0.2]
        test = df[df.t > 9][["x", "y", "t"]]
    if extra_test_sites:
        extra = pd.DataFrame({"x": rng.uniform(size=extra_test_sites).round(5),
                              "y": rng.uniform(size=extra_test_sites).round(5)})
        if not spatial_only:
            extra["t"] = 11
        test = pd.concat([test, extra], ignore_index=True)
    tr, te = tmp_path / "f_1_train.csv", tmp_path / "f_1_test.csv"
    train.to_csv(tr, index=False)
    test.to_csv(te, index=False)
    return tr, te


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("layout", ["space-time", "extra-test-sites",
                                    "spatial-only"])
def test_load_kaust_csv_equals_jax(tmp_path, normalize, layout):
    tr, te = _pair(tmp_path, spatial_only=layout == "spatial-only",
                   extra_test_sites=5 if layout == "extra-test-sites" else 0)
    got = tk.load_kaust_csv(tr, te, normalize=normalize, verbose=False)
    want = jk.load_kaust_csv(tr, te, normalize=normalize, verbose=False)
    for g, w, name in zip(got[:3], want[:3], ("z_train", "z_test", "coords")):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert got[3] == want[3] and list(got[3]) == list(want[3])
    gm, wm = got[4], want[4]
    assert gm.keys() == wm.keys()
    for k in wm:
        if k == "coords":
            np.testing.assert_array_equal(gm[k], wm[k])
        else:
            assert gm[k] == wm[k], k
    if layout == "spatial-only":
        assert (gm["T_tr"], gm["T_te"], gm["T_te_start"]) == (1, 1, 1)


def test_read_columns_reads_empty_fields_as_nan(tmp_path):
    p = tmp_path / "holes.csv"
    p.write_text('"x","y","t","z"\n0.5,0.25,1,\n0.1,0.2,2,3.5\n')
    cols = tk.read_columns(p)
    assert list(cols) == ["x", "y", "t", "z"]
    np.testing.assert_array_equal(cols["z"], [np.nan, 3.5])
    one = tmp_path / "one.csv"
    one.write_text("x,y\n0.5,0.25\n")
    assert tk.read_columns(one)["y"].tolist() == [0.25]


@pytest.mark.parametrize("method,frac", [("uniform", 0.3), ("biased", 0.2),
                                         ("uniform", 0.0)])
def test_sample_observed_sites_equals_jax(method, frac):
    coords = np.random.default_rng(4).uniform(size=(50, 2))
    for seed in (0, 7):
        got = tk.sample_observed_sites(coords, frac, method, seed=seed)
        want = jk.sample_observed_sites(coords, frac, method, seed=seed)
        np.testing.assert_array_equal(got, want)
        assert np.all(np.diff(got) > 0) and len(got) == max(1, int(50 * frac))
    with pytest.raises(ValueError, match="sampling"):
        tk.sample_observed_sites(coords, 0.5, "corner", seed=0)


@pytest.mark.parametrize("denormalize", [True, False])
def test_predictions_to_csv_equals_jax(tmp_path, denormalize):
    tr, te = _pair(tmp_path, extra_test_sites=3)
    _, z_test, _, site_to_idx, meta = tk.load_kaust_csv(tr, te, verbose=False)
    rng = np.random.default_rng(5)
    # one step short of the horizon: the last step's rows are NaN
    y_pred = rng.normal(size=(z_test.shape[0] - 1, z_test.shape[1])).astype(
        np.float32)
    out_t, out_j = tmp_path / "port.csv", tmp_path / "jax.csv"
    tk.predictions_to_csv(y_pred, te, out_t, site_to_idx, meta["z_mean"],
                          meta["z_std"], denormalize)
    jk.predictions_to_csv(y_pred, te, out_j, site_to_idx, meta["z_mean"],
                          meta["z_std"], denormalize)
    got, want = pd.read_csv(out_t), pd.read_csv(out_j)
    assert list(got.columns) == list(want.columns) == ["z"]
    np.testing.assert_array_equal(got["z"].to_numpy(), want["z"].to_numpy())
    assert got["z"].isna().sum() == want["z"].isna().sum() > 0


def test_write_z_csv_round_trips_every_digit(tmp_path):
    z = np.array([0.1, -1e-300, 1 / 3, np.nan, 2.5e17, np.float32(0.7)])
    tk.write_z_csv(z, tmp_path / "z.csv")
    back = pd.read_csv(tmp_path / "z.csv", float_precision="round_trip")
    np.testing.assert_array_equal(back["z"].to_numpy(), z)
    pd.DataFrame({"z": z}).to_csv(tmp_path / "pd.csv", index=False)
    assert (tmp_path / "z.csv").read_text() == (tmp_path / "pd.csv").read_text()


def test_competition_family_layout(tmp_path):
    """A family cut from a full field: train t <= T_train with rows missing
    at a share of the sites only, test t > T_train at every site without
    z, the solutions the true z of the test rows in their order."""
    field = tmp_path / "field.csv"
    df = _field(S=40, T=12, seed=2)
    df.to_csv(field, index=False)
    paths = write_competition_family(field, tmp_path / "fam", "2a", 8,
                                     T_train=9, site_share=0.25,
                                     row_share=0.5, seed=3)
    assert paths["stem"] == tmp_path / "fam" / "2a_8"
    train = pd.read_csv(paths["train"])
    test = pd.read_csv(paths["test"])
    sol = pd.read_csv(paths["solutions"])
    assert list(train.columns) == ["x", "y", "t", "z"]
    assert list(test.columns) == ["x", "y", "t"]
    assert list(sol.columns) == ["id", "z8"]
    full_test = df[df.t > 9].reset_index(drop=True)
    np.testing.assert_allclose(test[["x", "y", "t"]].to_numpy(),
                               full_test[["x", "y", "t"]].to_numpy())
    np.testing.assert_allclose(sol["z8"].to_numpy(), full_test["z"].to_numpy())
    assert train.t.max() == 9 and len(train) < len(df[df.t <= 9])
    z_train, z_test, _, _, meta = tk.load_kaust_csv(
        paths["train"], paths["test"], verbose=False)
    complete = (~np.isnan(z_train)).all(axis=0)
    assert 0 < complete.sum() < 40 and meta["T_te_start"] == 10
    assert z_test.shape == (3, 40)
