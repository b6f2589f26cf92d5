"""`python3 -m st_dadk_tpu_torch.ab_paired` (the port of the JAX package's
scripts/ab_paired.py) on the CPU, on a tiny workload: two seeds, two
epochs, both arms; the summary's keys, the paired per-seed deltas, and the
override parser's scalar rules."""
import json

import numpy as np
import pytest

from st_dadk_tpu_torch import ab_paired
from torch_threads import worker_threads  # noqa: F401


@pytest.fixture(scope="module")
def toy_csv(tmp_path_factory):
    d = tmp_path_factory.mktemp("ab")
    rng = np.random.default_rng(0)
    coords = rng.uniform(size=(40, 2)).round(5)
    lines = ["x,y,t,z"]
    for t in range(1, 13):
        for s in range(40):
            z = np.sin(3 * coords[s, 0]) + 0.1 * t / 12 + rng.normal(0, 0.05)
            lines.append(f"{coords[s, 0]},{coords[s, 1]},{t},{z:.6f}")
    (d / "toy.csv").write_text("\n".join(lines))
    return d / "toy.csv"


def test_overrides_parse_as_yaml_scalars():
    got = ab_paired.parse_overrides(
        ["epochs=250", "lr=1.0e-3", "train_dtype=bf16", "tail_compaction=true",
         "hidden_dims=[512, 512, 256]", "scheduler=null"])
    assert got == {"epochs": 250, "lr": 1e-3, "train_dtype": "bf16",
                   "tail_compaction": True, "hidden_dims": [512, 512, 256],
                   "scheduler": None}
    with pytest.raises(SystemExit):
        ab_paired.parse_overrides(["epochs"])


def test_ab_paired_runs_both_arms_on_the_cpu(toy_csv, tmp_path, capsys):
    out = tmp_path / "ab"
    rc = ab_paired.main([
        "--device", "cpu", "--data_file", str(toy_csv), "--n_experiments",
        "2", "--warmup_epochs", "1", "--out", str(out),
        "--a", "epochs=2", "hidden_dims=[16, 8]", "k_spatial_centers=[4, 9]",
        "k_temporal_centers=[5]", "obs_ratio=0.5",
        "--b", "packed_optimizer=true"])
    assert rc == 0
    table = json.loads((out / "ab_summary.json").read_text())
    assert table["card"] == "cpu"
    for arm in ("a", "b"):
        e = table[arm]
        assert e["n"] == 2 and set(e) >= {
            "overrides", "test_crps_mean", "test_crps_std", "test_rmse_mean",
            "wall_seconds", "wall_seconds_cold"}
        assert e["wall_seconds"] > 0 and e["wall_seconds_cold"] > 0
        assert np.isfinite(e["test_crps_mean"])
        assert not (out / f"warmup_{arm}").exists()
    assert table["b"]["overrides"]["packed_optimizer"] is True
    assert table["a"]["overrides"]["hidden_dims"] == [16, 8]
    p = table["paired"]
    assert p["n_pairs"] == 2 and set(p["crps_deltas"]) == {"1", "2"}
    deltas = [table["b"]["crps"][i] - table["a"]["crps"][i] for i in ("1", "2")]
    np.testing.assert_allclose(sorted(p["crps_deltas"].values()),
                               sorted(deltas), rtol=1e-12)
    assert np.isfinite(p["crps_delta_sigma"]) and "wall_ratio_b_over_a" in p
    assert "paired b-a CRPS delta" in capsys.readouterr().out
    # --arms refits one arm and still summarises both
    rc = ab_paired.main([
        "--device", "cpu", "--data_file", str(toy_csv), "--n_experiments",
        "2", "--warmup_epochs", "1", "--out", str(out), "--arms", "b",
        "--a", "epochs=2", "hidden_dims=[16, 8]", "k_spatial_centers=[4, 9]",
        "k_temporal_centers=[5]", "obs_ratio=0.5",
        "--b", "packed_optimizer=true"])
    again = json.loads((out / "ab_summary.json").read_text())
    assert rc == 0 and again["a"]["wall_seconds"] is None
    assert again["a"]["crps"] == table["a"]["crps"]
    assert again["b"]["crps"] == table["b"]["crps"]
