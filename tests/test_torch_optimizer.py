"""Port parity: LR tables, AdamW, clipping, damping and EMA
(st_dadk_tpu_torch.train.optimizer against st_dadk_tpu.train.optimizer)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from st_dadk_tpu.bench_workload import bench_workload as jax_bench
from st_dadk_tpu.config import ExperimentConfig as JaxConfig
from st_dadk_tpu.train import optimizer as jo
from st_dadk_tpu_torch.bench_workload import bench_workload as torch_bench
from st_dadk_tpu_torch.config import ExperimentConfig
from st_dadk_tpu_torch.train import optimizer as to
from torch_threads import worker_threads  # noqa: F401


@pytest.mark.parametrize("override", [
    dict(epochs=40),
    dict(epochs=25, spatial_learnable=False),
    dict(epochs=15, scheduler=None, warmup_epochs=0),
    dict(epochs=30, basis_unfreeze_epoch=0, basis_lr_rampup_epochs=0),
])
def test_lr_tables_exactly_equal(override):
    assert torch_bench() == jax_bench()
    for B in (1, 16):
        a = jo.build_lr_tables(JaxConfig.from_dict(jax_bench(**override)), B)
        b = to.build_lr_tables(ExperimentConfig.from_dict(
            torch_bench(**override)), B)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def _tree(rng):
    return {"basis": {"centers": rng.normal(size=(6, 2)).astype(np.float32)},
            "mlp": {"w": rng.normal(size=(7, 3)).astype(np.float32),
                    "b": rng.normal(size=(3,)).astype(np.float32)}}


def test_three_adamw_steps_match_jax():
    rng = np.random.default_rng(0)
    params = _tree(rng)
    grads = [_tree(rng) for _ in range(3)]
    lrs = [(2e-2, 0.0), (1.5e-2, 1e-3), (1e-2, 2e-3)]

    jp = {g: {k: jnp.asarray(v) for k, v in d.items()} for g, d in params.items()}
    state = jo.adamw_init(jp)
    for gr, (lm, lb) in zip(grads, lrs):
        jg = {g: {k: jnp.asarray(v) for k, v in d.items()} for g, d in gr.items()}
        jp, state = jo.adamw_update(jp, jg, state,
                                    jo.lr_tree_for(jp, jnp.float32(lm),
                                                   jnp.float32(lb)), 5e-4)

    tp = {g: {k: torch.nn.Parameter(torch.as_tensor(v)) for k, v in d.items()}
          for g, d in params.items()}
    opt = to.AdamW({g: list(d.values()) for g, d in tp.items()}, 5e-4)
    for gr, (lm, lb) in zip(grads, lrs):
        for g, d in tp.items():
            for k, p in d.items():
                p.grad = torch.as_tensor(gr[g][k])
        opt.step({"mlp": float(np.float32(lm)), "basis": float(np.float32(lb))})
    for g, d in tp.items():
        for k, p in d.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[g][k]),
                                       rtol=1e-6, atol=1e-7, err_msg=f"{g}.{k}")
    assert opt.step_count == int(state["step"]) == 3


def test_clip_damping_and_ema_match_jax():
    rng = np.random.default_rng(1)
    leaves = [rng.normal(size=s).astype(np.float32) for s in ((5, 3), (4,))]
    for max_norm in (0.5, 100.0):
        want = jo.clip_by_global_norm([jnp.asarray(x) for x in leaves], max_norm)
        got = [torch.as_tensor(x.copy()) for x in leaves]
        to.clip_by_global_norm_(got, max_norm)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)

    g = rng.normal(size=(8, 2)).astype(np.float32)
    c = rng.uniform(size=(8, 2)).astype(np.float32)
    c0 = (c + rng.normal(scale=0.2, size=(8, 2))).astype(np.float32)
    want = jo.gradient_damping(jnp.asarray(g), jnp.asarray(c), jnp.asarray(c0),
                               0.1, 5.0)
    got = to.gradient_damping(torch.as_tensor(g), torch.as_tensor(c),
                              torch.as_tensor(c0), 0.1, 5.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)

    ema = [torch.as_tensor(x.copy()) for x in leaves]
    new = [x + 1.0 for x in leaves]
    to.ema_update(ema, [torch.as_tensor(x) for x in new], 0.99375)
    want = jo.ema_update([jnp.asarray(x) for x in leaves],
                         [jnp.asarray(x) for x in new], 0.99375)
    for a, b in zip(ema, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
