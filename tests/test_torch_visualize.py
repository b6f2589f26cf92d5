"""The port's two data figures (`cli/visualize_obs_density.py`,
`cli/visualize_2b_data.py`) against the JAX package's scripts: on a CSV made
from a seed, the plotted arrays equal those the JAX package's loader and
obs-design functions give (the scripts' own arithmetic), and each CLI
writes its PNG."""
import numpy as np
import pytest

from st_dadk_tpu.dataio import kaust as jkaust
from st_dadk_tpu.dataio import obs_design as jobs
from st_dadk_tpu_torch.cli import visualize_2b_data as v2b
from st_dadk_tpu_torch.cli import visualize_obs_density as vod
from st_dadk_tpu_torch.dataio.kaust import load_kaust_csv_single
from torch_threads import worker_threads  # noqa: F401


def _csv(path, T, S, seed):
    rng = np.random.default_rng(seed)
    coords = rng.uniform(size=(S, 2)).round(5)
    lines = ["x,y,t,z"] if T else ["x,y,z"]
    for t in range(1, (T or 1) + 1):
        for s in range(S):
            z = np.cos(4 * coords[s, 1]) + 0.05 * t + rng.normal(0, 0.1)
            lines.append(f"{coords[s, 0]},{coords[s, 1]},"
                         + (f"{t}," if T else "") + f"{z:.6f}")
    path.write_text("\n".join(lines))
    return path


@pytest.fixture(scope="module")
def field(tmp_path_factory):
    return _csv(tmp_path_factory.mktemp("viz") / "field.csv", 24, 90, 11)


def _both(path):
    z_j, c_j, _ = jkaust.load_kaust_csv_single(str(path), normalize=False,
                                               verbose=False)
    z_t, c_t, _ = load_kaust_csv_single(path, normalize=False, verbose=False)
    np.testing.assert_array_equal(z_t, z_j)
    np.testing.assert_array_equal(c_t, c_j)
    return z_j, c_j


@pytest.mark.parametrize("seed,ratio,intensity", [(2025, 0.1, 10.0),
                                                  (7, 0.3, 2.5)])
def test_scenario_counts_are_the_jax_designs(field, seed, ratio, intensity):
    z, coords = _both(field)
    panels = vod.scenario_counts(z, coords, ratio, intensity, seed)
    assert [p["title"] for p in panels] == [s[0] for s in vod.SCENARIOS]
    for p, (_, method, pattern) in zip(panels, vod.SCENARIOS):
        w = jobs.spatial_obs_probs(coords, pattern, intensity)
        mask, _ = jobs.sample_observations(z, coords, method, ratio, w,
                                           seed=seed)
        np.testing.assert_array_equal(p["counts"], mask.sum(axis=0))
        assert p["observed_share"] == float(mask.mean())


@pytest.mark.parametrize("t,n_series", [(50, 5), (3, 4), (0, 200)])
def test_2b_arrays_are_the_jax_scripts(field, t, n_series):
    z, _ = _both(field)
    got = v2b.figure_arrays(z, t, n_series)
    # scripts/visualize_2b_data.py's arithmetic
    T, S = z.shape
    t_idx = min(max(t - 1, 0), T - 1)
    sites = np.random.default_rng(0).choice(S, size=min(n_series, S),
                                            replace=False)
    assert got["t_idx"] == t_idx
    np.testing.assert_array_equal(got["map"], z[t_idx])
    np.testing.assert_array_equal(got["sites"], sites)
    np.testing.assert_array_equal(got["series"], z[:, sites])


def test_2b_arrays_of_a_spatial_only_file(tmp_path):
    z, _ = _both(_csv(tmp_path / "xyz.csv", 0, 50, 3))
    got = v2b.figure_arrays(z, 50, 5)
    assert got["t_idx"] == 0 and "series" not in got
    np.testing.assert_array_equal(got["hist"], z[0][np.isfinite(z[0])])


def test_each_cli_writes_its_png(field, tmp_path, capsys):
    pytest.importorskip("matplotlib")
    out = tmp_path / "density.png"
    assert vod.main(["--data_file", str(field), "--out", str(out)]) == 0
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    out2 = tmp_path / "map.png"
    assert v2b.main(["--data_file", str(field), "--t", "5",
                     "--out", str(out2)]) == 0
    assert out2.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert f"saved -> {out2}" in capsys.readouterr().out


def test_flags_match_the_jax_scripts():
    assert vars(vod.parse_args([])) == {
        "data_file": "data/2a/2a_8.csv", "obs_ratio": 0.1, "intensity": 10.0,
        "seed": 2025, "out": "obs_density.png"}
    assert vars(v2b.parse_args([])) == {
        "data_file": "data/2a/2a_8.csv", "t": 50, "n_series": 5, "out": None}
