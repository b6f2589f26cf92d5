"""The plain reference against the program on the CPU at a toy size:
each agrees where it should, so that on the card a disagreement is the
program's."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from stbench.reference import data as rdata
from stbench.reference import train as rtrain
from stbench.reference.model import Net, f32_mm, tf32_mm, to_tf32

CFG = dict(obs_method="site-wise", obs_ratio=0.1, obs_spatial_pattern="corner",
           obs_spatial_intensity=10.0, split_method="random", train_ratio=0.8,
           epochs=30, lr=2e-2, spatial_learnable=True, basis_lr_ratio=0.05,
           basis_unfreeze_epoch=10, basis_lr_rampup_epochs=10,
           warmup_epochs=10, scheduler="cosine")


def test_tf32_rounding_by_hand():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, 1.0 + 2 ** -10,
                      -(1.0 + 2 ** -11), 1.0 + 2 ** -11 + 2 ** -20,
                      float("inf")])
    want = torch.tensor([1.0, 1.0 + 2 ** -9, 1.0 + 2 ** -10, -1.0,
                         1.0 + 2 ** -10, float("inf")])
    assert torch.equal(to_tf32(x), want)


def test_masks_and_points_are_the_programs(tmp_path):
    from st_dadk_tpu_torch.config import ExperimentConfig
    from st_dadk_tpu_torch.train.experiment import ExperimentSetup
    from stbench import standin
    params = dict(mean=0.1, std=1.0, phi_t=0.2, sigma2=1.0, range_=0.1,
                  nugget=0.001)
    sites, z = standin.make_field(5, 80, 10, params)
    path = standin.write_csv(tmp_path / "f.csv", sites, z)
    cfg = ExperimentConfig.from_dict(dict(CFG, data_file=str(path),
                                          base_seed=777, device="cpu"))
    s = ExperimentSetup(cfg, 3, "cpu", defer_model=True)
    zz, coords = standin.read_csv(path)
    masks = rdata.observation_split(zz, coords, CFG, 777 + 2)
    np.testing.assert_array_equal(masks["train"], s.train_mask)
    np.testing.assert_array_equal(masks["valid"], s.valid_mask)
    np.testing.assert_array_equal(masks["test"], s.test_mask)
    tr = rdata.points(zz, coords, masks["train"])
    np.testing.assert_array_equal(tr.packed()[:, :2], s.train_ps.coords)
    np.testing.assert_array_equal(tr.t, s.train_ps.t)
    np.testing.assert_array_equal(tr.y, s.train_ps.y)


@pytest.mark.parametrize("learnable", [False, True])
def test_lr_table_is_the_programs(learnable):
    from st_dadk_tpu_torch.config import ExperimentConfig
    from st_dadk_tpu_torch.train.optimizer import build_lr_tables
    cfg = dict(CFG, spatial_learnable=learnable)
    mlp, basis, _ = build_lr_tables(ExperimentConfig.from_dict(cfg), 7)
    tab = rtrain.lr_table(cfg, 7)
    np.testing.assert_array_equal(tab[:, 0], mlp)
    np.testing.assert_array_equal(tab[:, 1], basis)


@pytest.mark.parametrize("cap", [16, 8192, 100, 8000])
def test_bijection_is_the_programs(cap):
    from st_dadk_tpu_torch.train.loop import (hash_multipliers,
                                              hash_permutation_any)
    g = torch.Generator().manual_seed(cap)
    r = hash_multipliers(cap, g, "cpu")
    ours = rtrain.bijection(r, cap)
    assert torch.equal(ours, hash_permutation_any(r[None], cap)[0])
    assert torch.equal(torch.sort(ours).values, torch.arange(cap))


def _program_model(learnable: bool, seed: int):
    from st_dadk_tpu_torch.models.st_interp import ModelSpec, init_model
    from st_dadk_tpu_torch.ops.init_centers import init_spatial_centers
    spec = ModelSpec(k_spatial_centers=(4, 9), k_temporal_centers=(5, 3),
                     hidden_dims=(16, 8), dropout=0.1, output_dim=5,
                     spatial_learnable=learnable)
    c, bw = init_spatial_centers("uniform", [4, 9])
    return init_model(torch.Generator().manual_seed(seed), spec, c, bw,
                      device="cpu"), c, bw


@pytest.mark.parametrize("learnable", [False, True])
def test_forward_and_init_are_the_programs(learnable):
    model, c, bw = _program_model(learnable, 31)
    net = Net([4, 9], [5, 3], [16, 8], 5, learnable, 0.1, "cpu")
    params = net.init_weights(31, "cpu")
    prog = dict(model.named_parameters())
    assert list(prog) == list(net.names())
    for n, v in params.items():
        assert torch.equal(v, prog[n].detach()), n
    if learnable:
        params["basis.centers"] = prog["basis.centers"].detach()
        params["basis.log_bandwidths"] = prog["basis.log_bandwidths"].detach()
    consts = {"centers": torch.as_tensor(c), "bandwidths": torch.as_tensor(bw)}
    rng = np.random.default_rng(0)
    coords = torch.as_tensor(rng.random((300, 2), dtype=np.float32))
    t = torch.as_tensor(rng.random((300, 1), dtype=np.float32))
    want = model(coords, t, train=False).detach()
    got = net.forward(params, consts, coords, t)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-6)
    keep = torch.as_tensor(rng.random((300, 24)) < 0.9)
    got = net.forward(params, consts, coords, t, keep)
    want = model(coords, t, train=True, dropout_keep=keep).detach()
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-6)
    # the control departs from float32 by far more than rounding
    ctl = net.forward(params, consts, coords, t, keep, tf32_mm)
    assert float((ctl - got).abs().max()) > 1e-4


def test_tf32_product_gradient_rounds_both_sides():
    a = torch.randn(8, 5, requires_grad=True)
    b = torch.randn(5, 3, requires_grad=True)
    (tf32_mm(a, b) ** 2).sum().backward()
    g = to_tf32(2 * (to_tf32(a) @ to_tf32(b))).detach()
    assert torch.allclose(b.grad, to_tf32(a).detach().T @ g)
    assert torch.allclose(a.grad, g @ to_tf32(b).detach().T)
    assert torch.equal(f32_mm(a, b), a @ b)
