"""`python3 -m st_dadk_tpu_torch.bench` (the port of the JAX package's
bench.py) on the CPU: a tiny CSV made from a seed, 2 epochs, narrow widths,
M = 3 jobs a batch split into 2-lane batches (a ragged tail of 1), 2
windows of 0 s. The last line, the fits counted against the jobs run,
every fit's scores bitwise those of the same jobs through `run_job_batch`,
the details file, the median and spread arithmetic of bench.py:222-225,
the warm widths, and the refusal to run on a card that is absent."""
import json

import numpy as np
import pytest
import torch

from st_dadk_tpu_torch import bench
from st_dadk_tpu_torch.config import ExperimentConfig
from st_dadk_tpu_torch.train.batch_engine import run_job_batch
from torch_threads import worker_threads  # noqa: F401

M, LANE_WIDTH, WINDOWS = 3, 2, 2


@pytest.fixture(scope="module")
def toy_csv(tmp_path_factory):
    d = tmp_path_factory.mktemp("bench")
    rng = np.random.default_rng(7)
    coords = rng.uniform(size=(40, 2)).round(5)
    lines = ["x,y,t,z"]
    for t in range(1, 13):
        for s in range(40):
            z = np.sin(3 * coords[s, 0]) + 0.1 * t / 12 + rng.normal(0, 0.05)
            lines.append(f"{coords[s, 0]},{coords[s, 1]},{t},{z:.6f}")
    (d / "toy.csv").write_text("\n".join(lines))
    return d / "toy.csv"


def overrides(csv):
    return {"data_file": str(csv), "epochs": 2, "hidden_dims": [16, 8],
            "k_spatial_centers": [4, 9], "k_temporal_centers": [5],
            "obs_ratio": 0.5}


@pytest.fixture(scope="module")
def bench_run(toy_csv, tmp_path_factory):
    details = tmp_path_factory.mktemp("details") / "sub" / "details.json"
    argv = [str(M), "--device", "cpu", "--lane_width", str(LANE_WIDTH),
            "--windows", str(WINDOWS), "--window_seconds", "0",
            "--overrides",
            json.dumps(overrides(toy_csv)), "--details", str(details)]
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench.main(argv)
    return rc, buf.getvalue(), details


def test_last_line_parses_and_names_the_cpu(bench_run):
    rc, out, _ = bench_run
    assert rc == 0
    last = json.loads(out.strip().splitlines()[-1])
    assert last["metric"] == "fits_per_hour" and last["unit"] == "fits/hour"
    assert last["device"]["platform"] == "cpu"
    assert last["value"] > 0
    np.testing.assert_allclose(last["vs_baseline"],
                               last["value"] / bench.BASELINE_JOBLIB10_PROXY)


def test_details_file_and_fits_equal_jobs(bench_run, toy_csv):
    _, out, details = bench_run
    d = json.loads(details.read_text())
    assert d["partial"] is False and d["M"] == M
    assert d["data_file"] == str(toy_csv) and d["data_kind"] is None
    assert d["reference_scores"] is None
    assert d["warmup"]["epochs"] == 2
    assert set(d["warmup"]["seconds"]) == {"2", "1"}
    assert len(d["windows"]) == WINDOWS
    for w in d["windows"]:
        # a window of 0 s runs one batch of M jobs
        assert w["fits"] == w["jobs"] == M and len(w["seeds"]) == 1
        assert len(w["test_crps"]) == M and w["golden"] is None
        np.testing.assert_allclose(w["fits_per_hour"],
                                   w["fits"] / w["wall_seconds"] * 3600)
    med, spread = bench.window_summary([w["fits_per_hour"]
                                        for w in d["windows"]])
    assert d["fits_per_hour"] == med and d["window_spread_pct"] == spread
    assert d["fits_per_hour"] == json.loads(
        out.strip().splitlines()[-1])["value"]
    assert d["mean_n_epochs_run_last_window"] == 2.0
    assert d["test_crps_last_window"] == d["windows"][-1]["test_crps"]
    # the CPU launches no kernel
    assert not any(d["launches"].values())


def test_every_fit_is_bitwise_its_job_through_run_job_batch(bench_run,
                                                            toy_csv,
                                                            tmp_path):
    d = json.loads(bench_run[2].read_text())
    base = {**bench.bench_workload(**overrides(toy_csv))}
    for wi, w in enumerate(d["windows"]):
        assert w["seeds"] == [bench.SEED_BASE + wi * 100000]
        cfg = ExperimentConfig.from_dict({**base, "base_seed": w["seeds"][0]})
        jobs = [(cfg, i, tmp_path / f"w{wi}" / str(i))
                for i in range(1, M + 1)]
        res = []
        for chunk in bench.split(jobs, LANE_WIDTH):
            res += run_job_batch(chunk, device="cpu")
        assert [r["test_crps"] for r in res] == w["test_crps"]
        assert [r["test_rmse"] for r in res] == w["test_rmse"]
        assert [r["n_epochs_run"] for r in res] == w["n_epochs_run"]


def _jax_bench_arithmetic(rates):
    """bench.py:222-225, as written there."""
    rates = sorted(rates)
    fits_per_hour = rates[len(rates) // 2]          # median window
    spread_pct = ((rates[-1] - rates[0]) / fits_per_hour * 50.0
                  if fits_per_hour else 0.0)        # +/- half-range %
    return fits_per_hour, spread_pct


@pytest.mark.parametrize("rates", [
    [1200.0, 1320.5, 1100.25, 1250.0, 1190.0],
    [10.0, 30.0, 20.0, 40.0],
    [777.7],
    [0.0, 0.0, 0.0],
])
def test_median_and_spread_are_the_jax_tools(rates):
    assert bench.window_summary(rates) == _jax_bench_arithmetic(rates)


@pytest.mark.parametrize("m,w,want", [(16, 0, [16]), (16, 16, [16]),
                                      (16, 32, [16]), (3, 2, [2, 1]),
                                      (24, 16, [16, 8]), (32, 16, [16])])
def test_warm_widths_are_every_width_of_the_split(m, w, want):
    """bench.py:161-169: a width a distinct batch of the split."""
    assert bench.lane_widths(m, w) == want
    jobs = list(range(m))
    assert sorted({len(c) for c in bench.split(jobs, w)},
                  reverse=True) == want
    assert sum(bench.split(jobs, w), []) == jobs


def test_flags_default_to_the_jax_tools_variables(monkeypatch, tmp_path):
    """BENCH_* give the flags' defaults; without them the JAX tool's
    protocol, and a details file that is never the JAX tool's."""
    for k in ("BENCH_WINDOW_SECONDS", "BENCH_WINDOWS", "BENCH_LANE_WIDTH",
              "BENCH_OVERRIDES", "BENCH_DETAILS"):
        monkeypatch.delenv(k, raising=False)
    a = bench.parse_args([])
    assert (a.M, a.window_seconds, a.windows, a.lane_width) == (16, 90.0, 5, 0)
    assert json.loads(a.overrides) == {} and a.device == "cuda"
    assert a.details == bench.DEFAULT_DETAILS
    assert bench.DEFAULT_DETAILS.parent.name == "bench_torch"
    monkeypatch.setenv("BENCH_WINDOW_SECONDS", "120")
    monkeypatch.setenv("BENCH_WINDOWS", "3")
    monkeypatch.setenv("BENCH_LANE_WIDTH", "8")
    monkeypatch.setenv("BENCH_OVERRIDES", '{"epochs": 4}')
    monkeypatch.setenv("BENCH_DETAILS", str(tmp_path / "d.json"))
    a = bench.parse_args(["24"])
    assert (a.M, a.window_seconds, a.windows, a.lane_width) == (24, 120.0, 3, 8)
    assert json.loads(a.overrides) == {"epochs": 4}
    assert a.details == tmp_path / "d.json"
    assert bench.parse_args(["--windows", "2"]).windows == 2


def test_without_the_cpu_flag_and_no_card_the_run_exits_nonzero(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert bench.main(["2", "--windows", "1"]) == 2
    err = capsys.readouterr()
    assert "no CUDA device" in err.err and err.out == ""
