"""Dense-predict traffic: a closed loop with one caller. Each request is
the program's `train.loop.predict` of one model over `points` (coords, t)
query points, numpy in and numpy out, in the program's chunks.

Set-up draws the model's parameters on the device from the seed (centers
uniform on [0, 1]^2, bandwidths around each resolution's grid bandwidth,
the network's weights as the published initialisation draws them, the
LayerNorms and biases spread a little), hands them to the program's model
through its own loader, draws `point_sets` sets of query points (coords
uniform, t on the field's time grid) and warms the path with
`warm_requests` requests. The window sends the sets in turn until
`--seconds` have passed after a request.

After the window the reference evaluates the sampled requests' points and
the comparison below decides `correct`.
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from stbench.reference.model import Net, f32_mm, tf32_mm
from stbench.trace import Span


def draw_params(net: Net, seed: int, device: torch.device) -> Dict:
    """The model's parameters (named as the program names them), drawn on
    `device` in one uniform and one normal call."""
    from stbench.reference.model import uniform_grid
    gen = torch.Generator(device=device).manual_seed(int(seed))
    widths = [net.ks + net.kt, *net.hidden, net.out_dim]
    shapes = {"basis.centers": (net.ks, 2), "basis.log_bandwidths": (net.ks,)}
    for i in range(len(net.hidden)):
        shapes[f"mlp.linear_{i}.w"] = (widths[i], widths[i + 1])
        shapes[f"mlp.linear_{i}.b"] = (widths[i + 1],)
        shapes[f"mlp.ln_{i}.scale"] = (widths[i + 1],)
        shapes[f"mlp.ln_{i}.bias"] = (widths[i + 1],)
    shapes["mlp.out.w"] = (widths[-2], widths[-1])
    shapes["mlp.out.b"] = (widths[-1],)
    total = sum(int(np.prod(s)) for s in shapes.values())
    u = torch.rand((total,), generator=gen, device=device)
    g = torch.randn((total,), generator=gen, device=device)
    _, grid_bw = uniform_grid(net.k_spatial)
    grid_bw = torch.as_tensor(grid_bw, device=device)
    out, off = {}, 0
    for name, shape in shapes.items():
        n = int(np.prod(shape))
        a, b = u[off:off + n].reshape(shape), g[off:off + n].reshape(shape)
        off += n
        if name == "basis.centers":
            out[name] = a
        elif name == "basis.log_bandwidths":
            out[name] = torch.log(grid_bw * (0.75 + 0.5 * a))
        elif name.endswith(".scale"):
            out[name] = 1.0 + 0.1 * b
        elif name.endswith(".bias"):
            out[name] = 0.1 * b
        else:
            fan_in = shapes[name.rsplit(".", 1)[0] + ".w"][0]
            out[name] = (2.0 * a - 1.0) / float(np.sqrt(fan_in))
    return out


def run(ctx) -> Dict:
    cfg_file, traffic = ctx.config, ctx.traffic
    program = dict(cfg_file["program"])
    dev = ctx.device
    n_pts, chunk = int(traffic["points"]), int(program["eval_chunk"])
    T = int(cfg_file["field"]["times"])

    from st_dadk_tpu_torch.config import ExperimentConfig
    from st_dadk_tpu_torch.models.st_interp import (STInterp, lane_tree,
                                                    load_jax_params,
                                                    spec_from_config)
    from st_dadk_tpu_torch.ops import fused_first_layer as ffl
    from st_dadk_tpu_torch.train.loop import predict

    net = Net(program["k_spatial_centers"], program["k_temporal_centers"],
              program["hidden_dims"], len(program["quantile_levels"]),
              True, program["dropout"], dev)
    params = draw_params(net, ctx.seed, dev)
    spec = spec_from_config(ExperimentConfig.from_dict(dict(
        program, device=str(dev))))
    centers = params["basis.centers"].cpu().numpy()
    bws = torch.exp(params["basis.log_bandwidths"]).cpu().numpy()
    model = STInterp(spec, centers, bws)
    load_jax_params(model, lane_tree({k: v.cpu().numpy()
                                      for k, v in params.items()}))
    model = model.to(dev).eval()

    rng = np.random.default_rng([int(ctx.seed), 7])
    sets = [(rng.random((n_pts, 2), dtype=np.float32),
             (rng.integers(0, T, n_pts) / (T - 1)).astype(np.float32))
            for _ in range(int(traffic["point_sets"]))]
    keep = set(rng.choice(int(traffic["sample_from"]),
                          size=int(traffic["sample_requests"]),
                          replace=False).tolist())

    for i in range(int(traffic["warm_requests"])):
        predict(model, *sets[i % len(sets)], chunk)

    span = Span(dev, ctx.tmp) if ctx.trace else None
    if span is not None:
        span.warm()
    first, n_span = (int(traffic["trace"]["after_requests"]),
                     int(traffic["trace"]["requests"]))
    orig_count = ffl._count

    def count(fn, lead, n, k, h, basis_id):
        orig_count(fn, lead, n, k, h, basis_id)
        if span is not None:
            span.count(fn.__name__, lead, n, k, h)

    ffl._count = count
    kept: List = []
    lat: List[float] = []
    failed = 0
    try:
        t0 = time.perf_counter()
        ctx.window_started(t0)
        i = 0
        while True:
            if span is not None and i == first:
                span.start()
            coords, t = sets[i % len(sets)]
            ts = time.perf_counter()
            out = predict(model, coords, t, chunk)
            lat.append(time.perf_counter() - ts)
            if span is not None and i == first + n_span - 1:
                span.stop()
            if out.shape != (n_pts, len(program["quantile_levels"])) \
                    or not np.isfinite(out).all():
                failed += 1
            if i in keep:
                kept.append((i, i % len(sets), out))
            i += 1
            # a traced run goes on until its span has closed
            if time.perf_counter() - t0 >= ctx.seconds and (
                    span is None or span.closed):
                break
        wall = time.perf_counter() - t0
        peak = ctx.memory_peak()
    finally:
        ffl._count = orig_count
    kept.append((i - 1, (i - 1) % len(sets), out))
    del model
    lat_ms = np.asarray(lat) * 1e3
    e2e = {"predict_Mpts_per_s": len(lat) * n_pts / wall / 1e6,
           "predict_p95_ms": float(np.percentile(lat_ms, 95))}
    obs = {"kind": "predict", "model": dict(
        k_spatial=net.ks, k_temporal=net.kt, hidden=list(net.hidden),
        out_dim=net.out_dim, learnable=True)}
    if span is not None:
        span.extra.update(requests=n_span, points=n_pts)
        obs["span"] = span.finish()
        if obs["span"] is not None:
            launches = sum(v for (name, *_), v in
                           obs["span"]["launches"].items()
                           if name == "fused_first_layer_fwd")
            obs["span"]["fwd_launches_per_request"] = launches / n_span

    # the comparison
    consts = {}
    readings, worst = [], 0.0
    missing = int(traffic["sample_requests"]) - sum(
        1 for r, _, _ in kept[:-1])
    for req, si, out in kept:
        coords = torch.as_tensor(sets[si][0], device=dev)
        t = torch.as_tensor(sets[si][1], device=dev)
        want = net.predict(params, consts, coords, t, mm=f32_mm)
        got = torch.as_tensor(out, device=dev)
        scale = float(torch.sqrt(torch.mean(want.double() ** 2)))
        gap = (float(torch.max(torch.abs(got - want))) / scale
               if got.shape == want.shape else float("inf"))
        row = {"request": req, "set": si, "predict_gap": gap}
        if ctx.readings:
            ctl = net.predict(params, consts, coords, t, mm=tf32_mm)
            row["control_predict_gap"] = float(
                torch.max(torch.abs(ctl - want))) / scale
        readings.append(row)
        worst = max(worst, gap)
    limits = ctx.traffic["limits"]
    checks = [("predict_gap", worst, float(limits["predict_gap"])),
              ("requests_uncompared", float(max(missing, 0)), 0.0)]
    return dict(attempted=len(lat), failed=failed, e2e=e2e, obs=obs,
                checks=checks, readings=readings, memory_peak_bytes=peak,
                extra={"requests": len(lat), "window_s": wall})
