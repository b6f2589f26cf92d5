"""The plain versions' distance on the CPU is the correctly rounded float32
square root (`ops/basis.py::sqrt_rn`), and their exp (the Gaussian phi and
psi) is taken in float64 (`exp_rn`).

The intermittent CPU parity miss of the Tier-1 runs (the first wendland
case of test_torch_spatial_basis.py, test_torch_points_design.py and
test_torch_basis_points_design.py under `-n 6`) was torch's float32
`sqrt` on the CPU: it comes from MKL's vector math in chunks on the
OpenMP threads, and now and then one thread's whole chunk comes from MKL's
reduced-accuracy (VML_EP) kernel, about 12 bits accurate, although torch
asks for VML_HA. `exp` takes the same path, and so do float64 calls (about
35 bits then). The plain versions now take the root in float64 with one
exact Newton step, and exp in float64, and round once.

Bars: bitwise numpy's IEEE float32 square root, also when the float64 root
is off by MKL's VML_EP bound (2^-26 relative); exp within one float32 ulp
of the correctly rounded value under that fault; phi and psi against a
float64 reference at the phi bar, atol 2e-6 (tests/test_pallas_basis.py:46);
the Pallas parity case at the bars of tests/test_torch_spatial_basis.py."""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from st_dadk_tpu_torch.ops import basis
from st_dadk_tpu_torch.ops import spatial_basis_kernels as sbk

REPO = Path(__file__).resolve().parent.parent
PHI_ATOL = 2e-6


def _inputs(seed=1, n=300, k=130):
    """tests/test_torch_spatial_basis.py's inputs of its first case."""
    rng = np.random.default_rng(seed)
    coords = rng.uniform(size=(n, 2)).astype(np.float32)
    centers = rng.uniform(size=(k, 2)).astype(np.float32)
    bw = rng.uniform(0.1, 0.8, size=(k,)).astype(np.float32)
    g = rng.normal(size=(n, k)).astype(np.float32)
    return coords, centers, bw, g


def _wendland64(coords, centers, bw):
    x, c = coords.astype(np.float64), centers.astype(np.float64)
    r = np.minimum(np.sqrt(((x[:, None] - c[None]) ** 2).sum(-1))
                   / bw.astype(np.float64)[None], 1.0)
    return (1 - r) ** 6 * (35 * r * r + 18 * r + 3) / 3


def _gaussian64(coords, centers, bw):
    x, c = coords.astype(np.float64), centers.astype(np.float64)
    r = (np.sqrt(((x[:, None] - c[None]) ** 2).sum(-1))
         / (bw.astype(np.float64)[None] * basis.CALIBRATION_FACTORS["gaussian"]))
    return np.exp(-0.5 * r * r)


def _psi_inputs(seed=2, n=300, k=15):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=n).astype(np.float32),
            np.linspace(0, 1, k).astype(np.float32),
            rng.uniform(0.05, 0.3, size=k).astype(np.float32))


def _psi64(t, centers, bw):
    d = ((t.astype(np.float64)[:, None] - centers.astype(np.float64)[None])
         / bw.astype(np.float64)[None])
    return np.exp(-0.5 * d * d)


def _vml_ep(real, seed):
    """`real` (torch.sqrt or torch.exp) with its float64 results off by up
    to MKL's VML_EP bound, 2^-26 relative, as a faulty thread's chunk."""
    def call(x):
        out = real(x)
        if out.dtype == torch.float64:
            rel = np.random.default_rng(seed).uniform(-1, 1, tuple(out.shape))
            out = out * (1 + torch.as_tensor(rel) * 2.0 ** -26)
        return out
    return call


def _ulps(a, b):
    """|a - b| in float32 ulps of b, elementwise."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def test_sqrt_rn_is_the_ieee_root():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(1e-24, 1e-20, 1000),
                        rng.uniform(1e-6, 2.0, 100_000),
                        np.float32([1e-24, 0.25, 1.0, 2.0])]).astype(
        np.float32)
    got = basis.sqrt_rn(torch.as_tensor(x))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.sqrt(x))
    # the autograd path carries a float32 gradient
    t = torch.as_tensor(x[:64]).requires_grad_(True)
    (gt,) = torch.autograd.grad(basis.sqrt_rn(t).sum(), (t,))
    assert gt.dtype == torch.float32
    np.testing.assert_allclose(gt.numpy(), 0.5 / np.sqrt(x[:64]), rtol=1e-6)


def test_sqrt_rn_is_the_ieee_root_under_a_float64_vml_ep_fault(monkeypatch):
    rng = np.random.default_rng(4)
    x = np.concatenate([rng.uniform(1e-24, 1e-20, 1000),
                        rng.uniform(1e-6, 2.0, 100_000)]).astype(np.float32)
    monkeypatch.setattr(torch, "sqrt", _vml_ep(torch.sqrt, 5))
    got = basis.sqrt_rn(torch.as_tensor(x))
    np.testing.assert_array_equal(got.numpy(), np.sqrt(x))


def test_exp_rn_within_one_ulp_under_a_float64_vml_ep_fault(monkeypatch):
    x = -np.random.default_rng(6).uniform(0, 20, 100_000).astype(np.float32)
    want = np.exp(x.astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(basis.exp_rn(torch.as_tensor(x)).numpy(),
                                  want)
    monkeypatch.setattr(torch, "exp", _vml_ep(torch.exp, 7))
    assert _ulps(basis.exp_rn(torch.as_tensor(x)).numpy(), want).max() <= 1


@pytest.mark.parametrize("what", ["gaussian phi", "psi"])
def test_gaussian_phi_and_psi_take_exp_in_float64(monkeypatch, what):
    seen = []
    real = torch.exp
    monkeypatch.setattr(torch, "exp",
                        lambda x: seen.append(x.dtype) or real(x))
    if what == "psi":
        t, centers, bw = _psi_inputs()
        got = basis.temporal_basis_embed(*(torch.as_tensor(a)
                                           for a in (t, centers, bw)))
        want = _psi64(t, centers, bw)
    else:
        coords, centers, bw, _ = _inputs()
        got = sbk.spatial_basis_embed_kernel(
            *(torch.as_tensor(a) for a in (coords, centers, bw)), "gaussian")
        want = _gaussian64(coords, centers, bw)
    assert seen == [torch.float64]
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=PHI_ATOL)


def test_basis_matrix_takes_its_distance_from_sqrt_rn(monkeypatch):
    seen = []
    real = basis.sqrt_rn
    monkeypatch.setattr(basis, "sqrt_rn",
                        lambda x: seen.append(tuple(x.shape)) or real(x))
    coords, centers, bw, _ = _inputs()
    sbk.spatial_basis_embed_kernel(*(torch.as_tensor(a)
                                     for a in (coords, centers, bw)))
    assert seen == [(300, 130)]


def test_parity_case_after_a_thread_count_toggle(interpret_mode):
    """In one process: the setting of the k-means, CLI and grid test files
    (one torch thread, then the old count back), then the parity case that
    missed, against the Pallas embed in interpret mode."""
    import jax
    import jax.numpy as jnp
    from st_dadk_tpu.ops.pallas_basis import spatial_basis_embed_pallas
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.sqrt(torch.ones(4096))
    torch.set_num_threads(n)
    coords, centers, bw, g = _inputs()
    args = tuple(jnp.asarray(a) for a in (coords, centers, bw))
    want = np.asarray(spatial_basis_embed_pallas(*args, "wendland"))
    grads_j = jax.grad(lambda s, c, b: jnp.sum(spatial_basis_embed_pallas(
        s, c, b, "wendland") * jnp.asarray(g)), argnums=(0, 1, 2))(*args)
    s, c, b = (torch.as_tensor(a).requires_grad_(True)
               for a in (coords, centers, bw))
    out = sbk.spatial_basis_embed_kernel(s, c, b, "wendland")
    grads_t = torch.autograd.grad(torch.sum(out * torch.as_tensor(g)),
                                  (s, c, b))
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=0,
                               atol=PHI_ATOL)
    np.testing.assert_allclose(out.detach().numpy(),
                               _wendland64(coords, centers, bw), rtol=0,
                               atol=PHI_ATOL)
    for gt, gj in zip(grads_t, grads_j):
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=5e-3,
                                   atol=5e-4)


_FRESH = """
import json, sys
import numpy as np, torch
sys.path.insert(0, {repo!r})
from st_dadk_tpu_torch.ops import basis, spatial_basis_kernels as sbk
rng = np.random.default_rng(1)
coords = rng.uniform(size=(300, 2)).astype(np.float32)
centers = rng.uniform(size=(130, 2)).astype(np.float32)
bw = rng.uniform(0.1, 0.8, size=(130,)).astype(np.float32)
c, ce = torch.as_tensor(coords), torch.as_tensor(centers)
d2 = torch.clamp((c[:, None, 0] - ce[None, :, 0]) ** 2
                 + (c[:, None, 1] - ce[None, :, 1]) ** 2, min=1e-24)
root = basis.sqrt_rn(d2).numpy()
phi = sbk.spatial_basis_embed_kernel(c, ce, torch.as_tensor(bw)).numpy()
gauss = sbk.spatial_basis_embed_kernel(c, ce, torch.as_tensor(bw),
                                       "gaussian").numpy()
trng = np.random.default_rng(2)
t = trng.uniform(size=300).astype(np.float32)
tc = np.linspace(0, 1, 15).astype(np.float32)
tb = trng.uniform(0.05, 0.3, size=15).astype(np.float32)
psi = basis.temporal_basis_embed(*(torch.as_tensor(a)
                                   for a in (t, tc, tb))).numpy()
print(json.dumps({{"root_ulps": int((root != np.sqrt(d2.numpy())).sum()),
                  "phi": phi.tolist(), "gaussian": gauss.tolist(),
                  "psi": psi.tolist(), "threads": torch.get_num_threads()}}))
"""


def test_fresh_process_first_call_is_exact(tmp_path):
    """The first vector-math calls of a fresh process, on all its threads:
    the distances bitwise IEEE; Wendland phi, Gaussian phi and psi at the
    bar of their float64 references."""
    out = subprocess.run([sys.executable, "-c", _FRESH.format(repo=str(REPO))],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["root_ulps"] == 0
    coords, centers, bw, _ = _inputs()
    np.testing.assert_allclose(np.asarray(res["phi"], np.float32),
                               _wendland64(coords, centers, bw), rtol=0,
                               atol=PHI_ATOL)
    np.testing.assert_allclose(np.asarray(res["gaussian"], np.float32),
                               _gaussian64(coords, centers, bw), rtol=0,
                               atol=PHI_ATOL)
    np.testing.assert_allclose(np.asarray(res["psi"], np.float32),
                               _psi64(*_psi_inputs()), rtol=0, atol=PHI_ATOL)


@pytest.fixture
def interpret_mode():
    try:
        from jax.experimental.pallas import tpu as pltpu
    except ImportError:
        pytest.skip("pallas tpu backend unavailable")
    with pltpu.force_tpu_interpret_mode():
        yield
