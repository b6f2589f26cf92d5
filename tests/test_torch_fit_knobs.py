"""Two guards of the port's public surface.

- The JAX fit knobs that change a fit's numbers (`init_seed_rounds`,
  `init_em_dtype: bfloat16`, `ablate_validate: true`) reach the fit: the
  setup's init is the init with the knob, and the fit runs to its results;
  the JAX package's TPU knobs and `init_gmm_fused` (the same EM, see
  st_dadk_tpu_torch/config.py) are accepted.
- The public constructors put what they build on the card unless the
  caller names the CPU.
"""
import jax
import numpy as np
import pytest
import torch

from st_dadk_tpu.ops import init_centers as ji
from st_dadk_tpu_torch.config import ExperimentConfig
from st_dadk_tpu_torch.models import st_interp as tm
from st_dadk_tpu_torch.ops import init_centers as ti
from st_dadk_tpu_torch.train import experiment as texp
from torch_threads import worker_threads  # noqa: F401


@pytest.fixture(scope="module")
def toy_csv(tmp_path_factory):
    """A 12-site field over 6 times."""
    d = tmp_path_factory.mktemp("knobs")
    rng = np.random.default_rng(1)
    coords = rng.uniform(size=(12, 2)).round(5)
    lines = ["x,y,t,z"]
    for t in range(1, 7):
        for s in range(12):
            lines.append(f"{coords[s, 0]},{coords[s, 1]},{t},"
                         f"{np.sin(3 * coords[s, 0]) + 0.1 * t:.6f}")
    (d / "toy.csv").write_text("\n".join(lines))
    return d / "toy.csv"


def _cfg(toy_csv, **extra):
    return ExperimentConfig.from_dict({**dict(
        data_file=str(toy_csv), k_spatial_centers=[4], k_temporal_centers=[3],
        hidden_dims=[8], regression_type="multi-quantile",
        quantile_levels=[0.1, 0.5, 0.9], epochs=1), **extra})


def _setup_init(cfg):
    """The spatial init ExperimentSetup makes for `cfg`, recomputed from
    the setup's own streams with `init_spatial_centers` directly."""
    setup = texp.ExperimentSetup(cfg, 1, "cpu", defer_model=True)
    return setup, ti.init_spatial_centers(
        cfg.spatial_init_method, cfg.k_spatial_centers,
        setup.train_ps.coords,
        generator=torch.Generator().manual_seed(setup.experiment_seed),
        device="cpu", rng=setup.np_rng, **texp.init_knobs(cfg))


@pytest.mark.parametrize("knob,value", [("init_seed_rounds", 4),
                                        ("init_em_dtype", "bfloat16"),
                                        ("ablate_validate", True)])
def test_unported_knob_raises_at_setup(toy_csv, tmp_path, knob, value):
    """Once refused at setup, each knob now runs and changes what it
    should: the init knobs give the setup the GMM init with the knob (and
    another than without it, the bf16 EM within bf16's reach of it), and
    `ablate_validate` puts the train loss in place of the validation loss
    and 0 in place of the validation RMSE (JAX loop.py:550-551)."""
    # 9 centers: 4 seeding rounds then draw more than one seed a round
    gmm = dict(spatial_init_method="gmm", k_spatial_centers=[9],
               obs_ratio=0.9)
    cfg = _cfg(toy_csv, **gmm, **{knob: value})
    setup = texp.ExperimentSetup(cfg, 1, "cpu")
    centers = setup.model.spatial_centers_init.numpy()
    _, (want_c, want_bw) = _setup_init(cfg)
    np.testing.assert_array_equal(centers, want_c)
    np.testing.assert_array_equal(
        setup.model.spatial_bandwidths_init.numpy(), want_bw)
    _, (plain_c, _) = _setup_init(_cfg(toy_csv, **gmm))
    if knob == "init_seed_rounds":
        assert not np.array_equal(centers, plain_c)
    elif knob == "init_em_dtype":
        # bf16 keeps 8 bits of a distance: the EM's optimum moves by a few
        # thousandths of the unit square, far less than a center spacing
        np.testing.assert_allclose(centers, plain_c, atol=2e-2)
    res = texp.run_single_experiment(cfg, 1, tmp_path, device="cpu",
                                     verbose=False)
    assert (tmp_path / "results.json").exists()
    hist = res["training_history"]
    if knob == "ablate_validate":
        assert hist["val_loss"] == hist["train_loss"]
        assert hist["val_rmse"] == [0.0] * len(hist["val_rmse"])
    else:
        assert hist["val_loss"] != hist["train_loss"]


@pytest.mark.parametrize("knob,value", [("init_gmm_fused", True),
                                        ("remat", True),
                                        ("pregather", False),
                                        ("packed_optimizer", True),
                                        ("mesh_axis", "lanes"),
                                        ("init_em_dtype", "float32"),
                                        ("ablate_validate", False)])
def test_accepted_knob_sets_up(toy_csv, knob, value):
    """TPU knobs, `init_gmm_fused`, and the values of the init and
    validation knobs that keep the JAX default fit."""
    cfg = _cfg(toy_csv, spatial_init_method="gmm", **{knob: value})
    setup = texp.ExperimentSetup(cfg, 1, "cpu")
    # `packed_optimizer` and `mesh_axis` are fields since the port reads
    # them (tests/test_torch_packing.py, test_torch_multihost.py); the
    # others stay in `extra`
    field = knob in ("packed_optimizer", "mesh_axis")
    got = getattr(cfg, knob) if field else cfg.extra[knob]
    assert (knob in cfg.extra) != field
    assert setup.model is not None and got == value


def test_init_gmm_fused_gives_the_jax_sequential_numbers():
    """The knob only batches the resolutions' EMs in JAX: with the default
    tol the fused program's centers and bandwidths equal the sequential
    program's, so the port, which runs the EMs one resolution at a time,
    accepts it."""
    rng = np.random.default_rng(3)
    blobs = rng.uniform(0, 1, (6, 2))
    coords = (blobs[rng.integers(0, 6, 600)]
              + rng.normal(0, 0.04, (600, 2))).astype(np.float32)
    key = jax.random.PRNGKey(5)
    seq = ji.init_spatial_centers("gmm", [4, 9], coords, key=key)
    fused = ji.init_spatial_centers("gmm", [4, 9], coords, key=key,
                                    gmm_fused=True)
    for a, b in zip(seq, fused):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_model_constructors_default_to_the_card(monkeypatch):
    spec = tm.ModelSpec(k_spatial_centers=(4,), k_temporal_centers=(3,),
                        hidden_dims=(8,))
    gen = torch.Generator().manual_seed(0)
    cpu = tm.init_model(gen, spec, device="cpu")
    params, consts = tm.to_jax_params(cpu), tm.model_consts(cpu)
    if not torch.cuda.is_available():
        # no fallback: without a card, a call that names no device fails
        with pytest.raises(AssertionError, match="CUDA"):
            tm.init_model(gen, spec)
        with pytest.raises(AssertionError, match="CUDA"):
            tm.from_jax_params(spec, params, consts)
    moved = []
    monkeypatch.setattr(tm.STInterp, "to",
                        lambda self, device: moved.append(str(device))
                        or self)
    tm.init_model(gen, spec)
    tm.from_jax_params(spec, params, consts)
    assert moved == ["cuda", "cuda"]


def test_gmm_init_defaults_to_the_card(monkeypatch):
    as_tensor = torch.as_tensor
    devices = []

    def record(data, dtype=None, device=None):
        devices.append(str(device))
        return as_tensor(data, dtype=dtype, device="cpu")

    X = np.random.default_rng(2).uniform(size=(80, 2)).astype(np.float32)
    monkeypatch.setattr(torch, "as_tensor", record)
    centers, bw = ti.init_spatial_centers(
        "gmm", [4], X, generator=torch.Generator().manual_seed(0))
    assert devices == ["cuda"] and centers.shape == (4, 2)
