"""`python3 -m st_dadk_tpu_torch.bench_dense_inference` (the port of the JAX
package's scripts/bench_dense_inference.py) on the CPU at n = 512: the JAX
package's parameters carried across, each of the three arms (plain,
phi_kernel, fused) against JAX's `forward` (use_pallas=False, train=False),
the summary's keys, and the refusal to run on a card that is absent."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from st_dadk_tpu.models import st_interp as jm
from st_dadk_tpu_torch import bench_dense_inference as bdi
from st_dadk_tpu_torch.models.st_interp import from_jax_params
from torch_threads import worker_threads  # noqa: F401

N = 512
FWD_ATOL = 5e-5                   # tests/test_torch_model.py's forward bar


@pytest.fixture(scope="module")
def carried():
    """The bench model with JAX's parameters, JAX's quantiles on the
    tool's inputs, and those inputs."""
    spec_j = jm.ModelSpec(**dict(
        k_spatial_centers=(25, 81, 121), k_temporal_centers=(10, 15, 45),
        hidden_dims=(256, 256, 128), dropout=0.1, spatial_learnable=True,
        output_dim=5, use_delta_reparameterization=True, use_pallas=False))
    params, consts = jm.init_model(jax.random.PRNGKey(0), spec_j)
    coords, t = bdi.dense_inputs(N, torch.device("cpu"))
    want = np.asarray(jm.forward(spec_j, params, consts, None,
                                 jnp.asarray(coords.numpy()),
                                 jnp.asarray(t.numpy()), train=False))
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa
    model = from_jax_params(bdi.BENCH_SPEC, to_np(params), to_np(consts),
                            device="cpu").eval()
    return model, coords, t, want


def test_bench_spec_is_the_jax_scripts_model():
    s = bdi.BENCH_SPEC
    assert (s.k_spatial_centers, s.k_temporal_centers, s.hidden_dims) == (
        (25, 81, 121), (10, 15, 45), (256, 256, 128))
    assert s.spatial_learnable and s.delta_head and s.output_dim == 5
    assert s.dropout == 0.1 and s.spatial_basis_function == "wendland"
    assert not s.phi_route and s.compute_dtype == "f32"


@pytest.mark.parametrize("arm", bdi.ARMS)
def test_each_arm_matches_jax_forward(carried, arm):
    model, coords, t, want = carried
    with torch.no_grad():
        got = bdi.arm_forward(model, arm, coords, t).numpy()
    assert got.shape == (N, 5)
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_ATOL)


def test_inference_draws_no_dropout(carried):
    """train=False: two calls agree bitwise and the global stream is
    untouched."""
    model, coords, t, _ = carried
    state = torch.get_rng_state()
    with torch.no_grad():
        a = bdi.arm_forward(model, "fused", coords, t)
        b = bdi.arm_forward(model, "fused", coords, t)
    assert torch.equal(a, b) and torch.equal(state, torch.get_rng_state())


def test_run_checks_and_summary_keys(carried):
    model = carried[0]
    s = bdi.run(N, 2, "cpu", model=model)
    assert s["device"]["platform"] == "cpu" and s["n"] == N
    assert set(s["arms"]) == set(bdi.ARMS)
    for arm in bdi.ARMS:
        a = s["arms"][arm]
        assert set(a) == {"amortized_ms", "latency_ms", "mpts_per_s",
                          "peak_memory_mib"}
        assert a["amortized_ms"] > 0 and a["peak_memory_mib"] is None
        np.testing.assert_allclose(a["mpts_per_s"],
                                   N / a["amortized_ms"] / 1e3)
    assert set(s) >= {"checks", "launches", "phi_kernel_over_plain",
                      "fused_over_plain"}
    c = s["checks"]
    for arm in ("phi_kernel", "fused"):
        assert c["h1_max_abs"][arm] <= bdi.H1_ATOL
        assert c["out_max_abs"][arm] <= bdi.OUT_ATOL
    # on the CPU every wrapper takes its plain version: nothing launches
    assert c["launches_a_call"] == {arm: {} for arm in bdi.ARMS}
    assert not any(s["launches"].values())


def test_a_failed_check_raises(carried, monkeypatch):
    """A kernel arm away from plain fails the run; nothing falls back."""
    model, coords, t, _ = carried
    real = bdi.arm_forward

    def off(model, arm, coords, t):
        out = real(model, arm, coords, t)
        return out + 1e-2 if arm == "fused" else out

    monkeypatch.setattr(bdi, "arm_forward", off)
    with torch.no_grad(), pytest.raises(RuntimeError, match="fused"):
        bdi.check_arms(model, coords, t, torch.device("cpu"))


def test_main_writes_its_summary(tmp_path, capsys):
    out = tmp_path / "dense.json"
    assert bdi.main(["--device", "cpu", "--n", "256", "--reps", "1",
                     "--out", str(out)]) == 0
    s = json.loads(out.read_text())
    assert s["n"] == 256 and s["device"]["platform"] == "cpu"
    assert "fused/plain amortized ratio" in capsys.readouterr().out


def test_the_card_is_required_unless_the_cpu_is_asked_for(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bdi.run(64, 1, "cuda")
    out = tmp_path / "dense.json"
    assert bdi.main(["--n", "64", "--out", str(out)]) == 2
    assert "no CUDA device" in capsys.readouterr().err
    assert not out.exists()
