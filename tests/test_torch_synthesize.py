"""`st_dadk_tpu_torch.cli.synthesize_{1b3b,2b}` (the ports of the JAX
package's scripts/synthesize_{1b3b,2b}.py) on the CPU, against the JAX
scripts loaded by file path (as tests/test_family_scoring.py loads them).

The numpy functions (`fit_field`, `matern_rff`, `sample_field`,
`fit_2a_covariance`) are held bitwise to the JAX scripts' on the same
seeded inputs; `eval_latent` at LATENT_BAR; both CLIs end to end against
the JAX scripts' `main` on one generated reference tree: the same files,
columns and rows, `fit_params.json` equal, the inputs' own values (ids,
coordinates, the whole 2b field) equal, and the sampled values within the
latent's bar. The generated files carry 6 decimals, as the competition's
do: pandas' default CSV parser (the JAX scripts') can miss the correctly
rounded double of a 17-digit value by an ulp, where the port's reader
(Python's float) cannot.
"""
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from st_dadk_tpu_torch.cli import score_families
from st_dadk_tpu_torch.cli import synthesize_1b3b as port13
from st_dadk_tpu_torch.cli import synthesize_2b as port2b
from st_dadk_tpu_torch.dataio.kaust import read_columns, write_columns
from st_dadk_tpu_torch.dataio.synthetic import synthesize
from torch_threads import worker_threads  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
# eval_latent against the JAX script's (both float32, on the CPU): measured
# 1.2e-6 at most over 5 seeds at (range, m) = (0.0575, 1024), (0.12, 1024)
# and (0.0575, 256) with n = 3,000 (|omega| up to 476); the bar is 10x that
LATENT_BAR = 1e-5
M_FEATURES = 256


def _load(name, rel):
    spec = importlib.util.spec_from_file_location(name, REPO / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax13():
    return _load("synthesize_1b3b", "scripts/synthesize_1b3b.py")


@pytest.fixture(scope="module")
def jax2b():
    return _load("synthesize_2b", "scripts/synthesize_2b.py")


def _savetxt(path, cols, fmt):
    np.savetxt(path, np.column_stack(list(cols.values())), delimiter=",",
               header=",".join(cols), comments="", fmt=fmt)


def _write_2a(path, n_sites, T, seed, t0=1):
    """A complete (x, y, t, z) field in 2a_8's layout from the stand-in's
    covariance (`data/2b/fit_params.json`), 6 decimals."""
    params = json.loads((REPO / "data" / "2b" / "fit_params.json").read_text())
    sites = np.random.default_rng(seed).uniform(size=(n_sites, 2)).round(6)
    z = synthesize(sites, T, params, seed=seed + 1)
    _savetxt(path, {"x": np.tile(sites[:, 0], T),
                    "y": np.tile(sites[:, 1], T),
                    "t": np.repeat(np.arange(t0, t0 + T), n_sites),
                    "z": z.ravel()}, ["%.6f", "%.6f", "%d", "%.6f"])


def _field(coords, params, seed):
    """A Matern field at `coords` (float64 latent through numpy)."""
    om, ph = port13.matern_rff(params, 512, seed)
    lat = np.sqrt(2.0 / 512) * np.cos(coords @ om.T + ph).sum(1)
    return port13.sample_field(params, lat, seed + 1)


def _reference_tree(root: Path) -> Path:
    """1b: two fields of 400 test sites; 3b: one pair of 400 test sites
    (mixed at rho 0.5); 2a_8 with 300 sites x T = 20; 2b_8's test sites:
    150 x T = 10 (t = 91..100)."""
    ref = root / "ref"
    for fam in ("1b", "3b", "2a", "2b"):
        (ref / fam).mkdir(parents=True)
    rng = np.random.default_rng(11)
    p1 = dict(mean=1.5, std=1.8, sigma2=0.95, range_=0.12, nu=1.0,
              nugget=0.05)
    sol = {"id": np.arange(1, 401)}
    for i in (1, 2):
        xy = rng.uniform(size=(400, 2)).round(6)
        _savetxt(ref / "1b" / f"1b_{i}_test.csv", {"x": xy[:, 0],
                                                   "y": xy[:, 1]}, "%.6f")
        sol[f"z{i}"] = _field(xy, p1, 20 + i).round(6)
    _savetxt(ref / "1b" / "1b-solutions.csv", sol,
             ["%d", "%.6f", "%.6f"])
    xy = rng.uniform(size=(400, 2)).round(6)
    _savetxt(ref / "3b" / "3b_1_test.csv", {"x": xy[:, 0], "y": xy[:, 1]},
             "%.6f")
    a = _field(xy, dict(p1, mean=0.0, std=1.0), 30)
    b = _field(xy, dict(p1, mean=0.0, std=1.0, range_=0.2), 31)
    _savetxt(ref / "3b" / "3b-solutions.csv",
             {"id": np.arange(1, 401), "z1": a.round(6),
              "z2": (0.5 * a + np.sqrt(0.75) * b).round(6)},
             ["%d", "%.6f", "%.6f"])
    _write_2a(ref / "2a" / "2a_8.csv", 300, 20, seed=5)
    sites = rng.uniform(size=(150, 2)).round(6)
    _savetxt(ref / "2b" / "2b_8_test.csv",
             {"x": np.tile(sites[:, 0], 10), "y": np.tile(sites[:, 1], 10),
              "t": np.repeat(np.arange(91, 101), 150)},
             ["%.6f", "%.6f", "%d"])
    return ref


def _argv_13(ref, out):
    return ["--families", "1b", "3b", "--ref_data", str(ref), "--out_root",
            str(out), "--m_features", str(M_FEATURES)]


def _argv_2b(ref, out):
    return ["--indices", "8", "--T", "10", "--out_dir", str(out),
            "--fit_from", str(ref / "2a" / "2a_8.csv"),
            "--sites_from", str(ref / "2b")]


@pytest.fixture(scope="module")
def trees(tmp_path_factory, jax13, jax2b):
    """The reference tree, and the JAX scripts' and the port's outputs."""
    root = tmp_path_factory.mktemp("synth")
    ref = _reference_tree(root)
    argv = sys.argv
    try:
        sys.argv = ["synthesize_1b3b.py"] + _argv_13(ref, root / "jax")
        jax13.main()
        sys.argv = ["synthesize_2b.py"] + _argv_2b(ref, root / "jax" / "2b")
        jax2b.main()
    finally:
        sys.argv = argv
    assert port13.main(_argv_13(ref, root / "port")
                       + ["--device", "cpu"]) == 0
    assert port2b.main(_argv_2b(ref, root / "port" / "2b")
                       + ["--device", "cpu"]) == 0
    return ref, root / "jax", root / "port"


# ---------------------------------------------------------------------------
# the numpy functions, bitwise
# ---------------------------------------------------------------------------

def test_fit_field_bitwise(jax13):
    rng = np.random.default_rng(0)
    coords = rng.uniform(size=(2000, 2))
    z = _field(coords, dict(mean=0.3, std=2.0, sigma2=0.8, range_=0.1,
                            nu=1.0, nugget=0.2), 3)
    for seed in (0, 7):
        assert port13.fit_field(coords, z, seed=seed) == \
            jax13.fit_field(coords, z, seed=seed)


@pytest.mark.parametrize("range_, m", [(0.0575, 1024), (0.12, 256)])
def test_matern_rff_and_sample_field_bitwise(jax13, range_, m):
    p = dict(mean=-0.45, std=1.65, sigma2=0.95, range_=range_, nu=1.0,
             nugget=0.05)
    om, ph = port13.matern_rff(p, m, 2026)
    om_j, ph_j = jax13.matern_rff(p, m, 2026)
    assert np.array_equal(om, om_j) and np.array_equal(ph, ph_j)
    lat = np.random.default_rng(1).standard_normal(500)
    assert np.array_equal(port13.sample_field(p, lat, 9),
                          jax13.sample_field(p, lat, 9))


def test_fit_2a_covariance_bitwise(jax2b, tmp_path):
    path = tmp_path / "2a_8.csv"
    _write_2a(path, 300, 20, seed=5)
    got = port2b.fit_2a_covariance(path)
    assert got == jax2b.fit_2a_covariance(path)
    assert set(got) == {"mean", "std", "phi_t", "sigma2", "range_", "nu",
                        "nugget"}


# ---------------------------------------------------------------------------
# eval_latent
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("range_, m", [(0.0575, 1024), (0.12, 1024),
                                       (0.0575, 256)])
def test_eval_latent_matches_jax(jax13, range_, m):
    rng = np.random.default_rng(3)
    coords = rng.uniform(size=(3000, 2))
    om, ph = port13.matern_rff(dict(nu=1.0, range_=range_), m, 4)
    got = port13.eval_latent(coords, om, ph, device="cpu")
    want = jax13.eval_latent(coords, om, ph)
    assert got.dtype == np.float64 and got.shape == (3000,)
    assert np.abs(got - want).max() <= LATENT_BAR


def test_eval_latent_chunks_agree():
    """A chunk of points at a time: each point's latent is its own row's
    sum, whatever the chunking."""
    rng = np.random.default_rng(5)
    coords = rng.uniform(size=(1000, 2))
    om, ph = port13.matern_rff(dict(nu=1.0, range_=0.1), 128, 6)
    whole = port13.eval_latent(coords, om, ph, device="cpu")
    assert np.array_equal(whole, port13.eval_latent(coords, om, ph,
                                                    chunk=77, device="cpu"))


# ---------------------------------------------------------------------------
# the CLIs end to end, against the JAX scripts' main
# ---------------------------------------------------------------------------

def _files(root):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*")
                  if p.is_file())


def test_cli_files_and_params_match_jax(trees):
    _, jax_out, port_out = trees
    assert _files(port_out) == _files(jax_out) == [
        "1b/1b_1.csv", "1b/1b_1_synthsol.csv", "1b/1b_2.csv",
        "1b/1b_2_synthsol.csv", "1b/fit_params.json", "2b/2b_8.csv",
        "2b/fit_params.json", "3b/3b_1.csv", "3b/3b_1_synthsol.csv",
        "3b/fit_params.json"]
    for fam in ("1b", "2b", "3b"):
        got = json.loads((port_out / fam / "fit_params.json").read_text())
        assert got == json.loads((jax_out / fam / "fit_params.json")
                                 .read_text()), fam


def test_cli_2b_field_bitwise(trees):
    _, jax_out, port_out = trees
    got = (port_out / "2b" / "2b_8.csv").read_bytes()
    assert got == (jax_out / "2b" / "2b_8.csv").read_bytes()
    cols = read_columns(port_out / "2b" / "2b_8.csv")
    assert list(cols) == ["x", "y", "t", "z"] and len(cols["z"]) == 1500
    assert np.array_equal(cols["t"], np.repeat(np.arange(1, 11), 150))


@pytest.mark.parametrize("name, header, rows", [
    ("1b/1b_1.csv", ["id_train", "x", "y", "z"], 3600),
    ("1b/1b_2_synthsol.csv", ["id", "z"], 400),
    ("3b/3b_1.csv", ["x", "y", "z1", "z2"], 3600),
    ("3b/3b_1_synthsol.csv", ["id", "z1", "z2"], 400)])
def test_cli_1b3b_values_match_jax(trees, name, header, rows):
    """Ids and coordinates equal; each sampled value within the latent's
    bar times its field's scale, as float32 (9 digits parse back to the
    float32 pandas writes in its shortest form)."""
    _, jax_out, port_out = trees
    got, want = read_columns(port_out / name), read_columns(jax_out / name)
    assert list(got) == list(want) == header
    fam, field = name.split("/")[0], name.split("/")[1].split("_")
    params = json.loads((port_out / fam / "fit_params.json").read_text())[
        f"{field[0]}_{field[1].split('.')[0]}"]
    for col in header:
        assert len(got[col]) == rows
        if not col.startswith("z"):
            assert np.array_equal(got[col], want[col]), col
            continue
        p = params[col]
        g32 = got[col].astype(np.float32)
        w = want[col].astype(np.float32).astype(np.float64)
        # a 3b second field mixes two latents: at most sqrt(2) x the bar
        bar = 2.0 * LATENT_BAR * p["std"] * np.sqrt(p["sigma2"])
        d = np.abs(g32.astype(np.float64) - w)
        assert (d <= bar + 2.0 ** -22 * np.abs(w)).all(), (col, d.max())


def test_score_families_lists_the_synth_jobs(trees):
    ref, _, port_out = trees
    jobs = [j for j in score_families.iter_jobs(["1b", "3b"], ref, port_out)
            if j["mode"] == "synth"]
    assert [j["name"] for j in jobs] == ["1b_1@synth", "1b_2@synth",
                                         "3b_1.z1@synth", "3b_1.z2@synth"]
    assert jobs[0]["train_csv"] == port_out / "1b" / "1b_1.csv"
    assert jobs[0]["sol_path"] == port_out / "1b" / "1b_1_synthsol.csv"
    assert jobs[0]["test_csv"] == ref / "1b" / "1b_1_test.csv"
    assert [j["sol_col"] for j in jobs] == ["z", "z", "z1", "z2"]


@pytest.mark.parametrize("tool", ["1b3b", "2b"])
def test_cli_missing_inputs_exit_nonzero(tool, tmp_path, capsys):
    absent = tmp_path / "absent"
    if tool == "1b3b":
        rc = port13.main(["--families", "1b", "--ref_data", str(absent),
                          "--out_root", str(tmp_path / "out"),
                          "--device", "cpu"])
        named = absent / "1b" / "1b-solutions.csv"
    else:
        rc = port2b.main(["--fit_from", str(absent / "2a_8.csv"),
                          "--sites_from", str(absent), "--out_dir",
                          str(tmp_path / "out"), "--device", "cpu"])
        named = absent / "2a_8.csv"
    assert rc == 2
    assert str(named) in capsys.readouterr().err
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("tool", ["1b3b", "2b"])
def test_cli_refuses_a_missing_card(tool, tmp_path, capsys, monkeypatch):
    """Without --device cpu the run needs the card, and does not fall back
    to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = port13.main if tool == "1b3b" else port2b.main
    out = ["--out_root" if tool == "1b3b" else "--out_dir",
           str(tmp_path / "out")]
    assert main(out) == 2
    assert "no CUDA device" in capsys.readouterr().err
    assert not (tmp_path / "out").exists()


def test_write_columns_round_trips(tmp_path):
    rng = np.random.default_rng(8)
    z = (rng.standard_normal(1000) * 10.0 ** rng.integers(-8, 8, 1000)
         ).astype(np.float32)
    x = rng.uniform(size=1000) * 10.0 ** rng.integers(-8, 8, 1000)
    write_columns(tmp_path / "f.csv", {"id": np.arange(1000), "x": x,
                                          "z": z})
    cols = read_columns(tmp_path / "f.csv")
    assert np.array_equal(cols["x"], x)
    assert np.array_equal(cols["z"].astype(np.float32), z)
    assert np.array_equal(cols["id"], np.arange(1000))


# ---------------------------------------------------------------------------
# the JAX test's round trips (tests/test_family_scoring.py:40-100), on the
# port
# ---------------------------------------------------------------------------

def test_latent_is_unit_variance():
    coords = np.random.default_rng(0).uniform(size=(4000, 2))
    om, ph = port13.matern_rff(dict(nu=1.0, range_=0.1), m=2048, seed=1)
    lat = port13.eval_latent(coords, om, ph, device="cpu")
    assert abs(lat.mean()) < 0.1
    assert 0.85 < lat.std() < 1.15


def test_field_matches_fitted_covariance():
    """fit -> sample -> refit: the refitted range and sill land near the
    generating ones."""
    coords = np.random.default_rng(2).uniform(size=(6000, 2))
    p_true = dict(mean=1.5, std=2.0, sigma2=0.9, range_=0.12, nu=1.0,
                  nugget=0.1)
    om, ph = port13.matern_rff(p_true, m=4096, seed=3)
    lat = port13.eval_latent(coords, om, ph, device="cpu")
    z = port13.sample_field(p_true, lat, seed=4)
    p_fit = port13.fit_field(coords, z, seed=5)
    assert p_fit["mean"] == pytest.approx(float(z.mean()))
    assert p_fit["std"] == pytest.approx(float(z.std()))
    assert 0.5 * p_true["range_"] < p_fit["range_"] < 2.0 * p_true["range_"]
    assert abs(p_fit["sigma2"] - p_true["sigma2"]) < 0.3


def test_correlated_pair_mixing():
    """3b's one-factor coregionalization reproduces the requested
    cross-correlation."""
    coords = np.random.default_rng(6).uniform(size=(4000, 2))
    p = dict(nu=1.0, range_=0.03)
    om, ph = port13.matern_rff(p, m=2048, seed=7)
    om2, ph2 = port13.matern_rff(p, m=2048, seed=8)
    lat_s = port13.eval_latent(coords, om, ph, device="cpu")
    lat_i = port13.eval_latent(coords, om2, ph2, device="cpu")
    rho = 0.6
    lat2 = rho * lat_s + np.sqrt(1 - rho * rho) * lat_i
    assert abs(np.corrcoef(lat_s, lat2)[0, 1] - rho) < 0.1
