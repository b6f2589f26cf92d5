"""The frozen copies inside stbench/, pinned against hand-computed numbers
and against the code they were copied from."""
from __future__ import annotations

import numpy as np
import pytest

from stbench import standin, yardstick as ys


def test_model_flops_by_hand():
    # 2 (297*256 + 256*256 + 256*128 + 128*5)
    assert ys.forward_row_flops(227, 70, [256, 256, 128], 5) == 349_952
    # the forward three times, less the first layer's input gradient
    assert ys.train_row_flops(227, 70, [256, 256, 128], 5, False) == 897_792
    # and the centers' g . w^T product, 2 * 227 * 256
    assert ys.train_row_flops(227, 70, [256, 256, 128], 5, True) == 1_014_016


@pytest.mark.parametrize("n, micros", [(512, 0.36065), (2000, 1.40879),
                                       (32768, 23.08123)])
def test_fused_forward_bound_is_the_kernel_tables(n, micros):
    """The port's kernel table: 0.36 / 1.41 / 23.1 us at k = 227, H = 256,
    bound by the products (2 n k h at 495/3 TFLOP/s)."""
    assert ys.fused_least_seconds("fwd", 1, n, 227, 256) * 1e6 == \
        pytest.approx(micros, rel=1e-4)
    assert ys.fused_least_seconds("fwd", 16, n, 227, 256) == \
        pytest.approx(16 * ys.fused_least_seconds("fwd", 1, n, 227, 256))


def test_bytes_bound_a_thin_kernel():
    # k = 1, h = 1: products 2n, chain 20n, bytes 4 (2n + 3 + 1 + n) = 12n+16
    n = 1_000_000
    p, c, b = ys.fused_kernel_work("fwd", 1, n, 1, 1)
    assert (p, c, b) == (2 * n, 20 * n, 12 * n + 16)
    assert ys.least_seconds(p, c, b) == pytest.approx((12 * n + 16) / 3.35e12)
    _, c2, b2 = ys.fused_kernel_work("bwd_centers", 1, n, 1, 1)
    assert (c2, b2) == (25 * n, 4 * (2 * n + 3 + 1 + n + 3))


def test_intervals_by_hand():
    iv = [(3.0, 4.0), (0.0, 1.0), (0.5, 2.0), (1.5, 1.8), (5.0, 5.0)]
    assert ys.union(iv) == [(0.0, 2.0), (3.0, 4.0)]
    assert ys.covered(iv) == 3.0
    assert ys.gaps(iv, 0.0, 6.0) == [(2.0, 3.0, 1), (4.0, 6.0, -1)]
    assert ys.gaps(iv, -1.0, 3.5) == [(-1.0, 0.0, 0), (2.0, 3.0, 1)]


def test_union_is_trace_steady_states():
    from st_dadk_tpu_torch.trace_steady_state import _merge
    rng = np.random.default_rng(1)
    s = rng.uniform(0, 10, 200)
    iv = list(zip(s, s + rng.exponential(0.1, 200)))
    assert ys.union(iv) == [tuple(x) for x in _merge(iv)]


def test_trace_readings_by_hand():
    trace = {"traceEvents": [
        {"ph": "X", "cat": "kernel", "ts": 0, "dur": 100,
         "name": "void (anonymous namespace)::fwd_kernel<64, 256, 2, 32>(float"
                 " const*)"},
        {"ph": "X", "cat": "kernel", "ts": 50, "dur": 100, "name": "gemm"},
        {"ph": "X", "cat": "gpu_memcpy", "ts": 400, "dur": 50,
         "name": "Memcpy DtoH"},
        {"ph": "X", "cat": "cpu_op", "ts": 0, "dur": 1000, "name": "aten"},
    ]}
    ev = ys.device_events(trace)
    assert len(ev) == 3
    span = {"events": ev, "window_s": 1e-3,
            "launches": {("fused_first_layer_fwd", 2, 512, 227, 256): 3}}
    assert ys.busy_seconds(ev) == pytest.approx(200e-6)
    assert ys.idle_pct(span) == pytest.approx(80.0)
    assert ys.copy_pct(span) == pytest.approx(5.0)
    least = 3 * 2 * 0.36065e-6
    assert ys.fused_roofline_pct(span, "fwd") == pytest.approx(
        100 * least / 100e-6, rel=1e-4)
    assert ys.fused_roofline_pct(span, "bwd_centers") is None
    bd = ys.breakdown(ev)
    assert bd["device_ops"][0][0] == "fwd_kernel<64, 256, 2, 32>"
    assert bd["device_ops"][0][1] == pytest.approx(100e-6)
    assert bd["idle_gaps"][0][0] == "after gemm before Memcpy DtoH"
    assert bd["idle_gaps"][0][1] == pytest.approx(250e-6)


def test_mfu_of_a_span_by_hand():
    model = dict(k_spatial=227, k_temporal=70, hidden=[256, 256, 128],
                 out_dim=5, learnable=False)
    span = {"events": [{"name": "k", "cat": "kernel", "start": 0, "end": 1}],
            "window_s": 2.0, "M": 128, "epochs": 5, "B": 16, "bs": 512,
            "val_cap": 2000}
    flops = 5 * 128 * (16 * 512 * 897_792 + 2000 * 349_952)
    assert ys.mfu_pct(span, model) == pytest.approx(
        100 * flops / (2.0 * 495e12 / 3))
    pred = {"events": span["events"], "window_s": 1.0, "requests": 20,
            "points": 1_000_000}
    assert ys.mfu_pct(pred, model) == pytest.approx(
        100 * 20e6 * 349_952 / (495e12 / 3))


def test_standin_is_a_copy_of_the_programs_generator(tmp_path):
    from st_dadk_tpu_torch.dataio import synthetic
    from st_dadk_tpu_torch.dataio.kaust import load_kaust_csv_single
    import json
    params = json.loads((synthetic.REPO / synthetic.FIT_PARAMS).read_text())
    sites = np.random.default_rng(3).uniform(size=(40, 2)).round(6)
    ours = standin.synthesize(sites, 6, params, np.random.default_rng(11))
    theirs = synthetic.synthesize(sites, 6, params, seed=11)
    np.testing.assert_array_equal(ours, theirs)
    s1, z1 = standin.make_field(99, 40, 6, params)
    s2, z2 = standin.make_field(99, 40, 6, params)
    np.testing.assert_array_equal(z1, z2)
    assert z1.shape == (6, 40) and s1.shape == (40, 2)
    assert not np.array_equal(z1, standin.make_field(98, 40, 6, params)[1])
    path = standin.write_csv(tmp_path / "f.csv", s1, z1)
    z_ref, c_ref = standin.read_csv(path)
    z_prog, c_prog, _ = load_kaust_csv_single(path, normalize=False,
                                              verbose=False)
    np.testing.assert_array_equal(z_ref, z_prog)
    np.testing.assert_array_equal(c_ref, c_prog)
