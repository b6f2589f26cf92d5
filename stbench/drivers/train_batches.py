"""Training traffic: a stream of lane batches through the program's batch
pipeline (`train.batch_engine.run_job_batches`), each batch `lanes` fits of
the configuration at consecutive experiment seeds.

Set-up writes the run's stand-in field, builds and warms the program with
one short batch at the cell's width through the same entry
(`warm_epochs`), and installs the observation of `stbench/capture.py`.
The window then streams whole batches until `--seconds` have passed when
the pipeline pulls its next batch, so it ends within one batch of them, and
its time runs from the first pull to the last batch's result.
`lane_epochs_per_s` is the lanes x epochs of every batch over that time.

After the window the reference (`stbench/reference/`) follows the sampled
lanes of every batch and the comparison below decides `correct`.
"""
from __future__ import annotations

import math
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from stbench import standin
from stbench.capture import Capture
from stbench.reference import data as rdata
from stbench.reference import train as rtrain
from stbench.reference.model import Net, f32_mm, tf32_mm, uniform_grid
from stbench.trace import Span

SEED_SPAN = 2_000_000_000


def batch_base(seed: int, bi: int) -> int:
    """The base experiment seed of the window's batch bi (bi = -1: the
    warm-up batch): distinct batches, every seed a valid numpy seed."""
    return 1 + (int(seed) * 1_000_003 + (bi + 1) * 7_919) % SEED_SPAN


def run(ctx) -> Dict:
    cfg_file, traffic = ctx.config, ctx.traffic
    program = dict(cfg_file["program"])
    lanes, epochs = int(traffic["lanes"]), int(program["epochs"])
    field = cfg_file["field"]

    sites, z = standin.make_field(ctx.seed, int(field["sites"]),
                                  int(field["times"]), field["params"])
    csv = standin.write_csv(ctx.tmp / "field.csv", sites, z)

    from st_dadk_tpu_torch.config import ExperimentConfig
    from st_dadk_tpu_torch.train.batch_engine import run_job_batches

    sample = int(traffic["sample_lanes"])

    def pick(seeds: List[int]) -> List[int]:
        rng = np.random.default_rng([int(ctx.seed), int(seeds[0])])
        return sorted(rng.choice(len(seeds), size=min(sample, len(seeds)),
                                 replace=False).tolist())

    capture = Capture(pick, steps=int(traffic["follow_steps"])).install()
    try:
        def jobs(bi: int, n_epochs: int) -> List:
            out = ctx.tmp / "fits" / f"b{bi}"
            cfgs = [ExperimentConfig.from_dict(dict(
                program, data_file=str(csv),
                epochs=n_epochs, base_seed=batch_base(ctx.seed, bi),
                device=str(ctx.device), save_plots=False,
                save_artifacts=False)) for i in range(1, lanes + 1)]
            return [(c, i, out / str(i)) for i, c in enumerate(cfgs, 1)]

        run_job_batches([jobs(-1, int(traffic["warm_epochs"]))],
                        device=ctx.device)
        if ctx.trace:
            capture.span = Span(ctx.device, ctx.tmp)
            capture.span.warm()
            capture.span_batch = int(traffic["trace"]["batch"])
            capture.span_epochs = (int(traffic["trace"]["after_epochs"]),
                                   int(traffic["trace"]["epochs"]))
        capture.active = True
        pulled = []
        t0 = time.perf_counter()
        ctx.window_started(t0)

        def stream():
            bi = 0
            while True:
                pulled.append(bi)
                yield jobs(bi, epochs)
                bi += 1
                # a traced run goes on until its traced batch has run
                if time.perf_counter() - t0 >= ctx.seconds and (
                        capture.span is None or bi > capture.span_batch):
                    return

        results = run_job_batches(stream(), device=ctx.device)
        if ctx.device.type == "cuda":
            torch.cuda.synchronize(ctx.device)
        wall = time.perf_counter() - t0
        capture.active = False
        peak = ctx.memory_peak()
    finally:
        capture.uninstall()

    attempted = lanes * len(pulled)
    failed = attempted - len(results) + sum(
        1 for r in results if r["n_epochs_run"] != epochs
        or not all(math.isfinite(v) for split in r["metrics"].values()
                   for v in split.values()))
    lane_epochs = sum(r["n_epochs_run"] for r in results)
    e2e = {"lane_epochs_per_s": lane_epochs / wall}

    # one row of timings a batch (every lane of a batch carries the batch's)
    timings = {}
    for r in results:
        st = r["stage_timings"]
        timings.setdefault(r["config"]["base_seed"], st)
    span = capture.span.finish() if capture.span is not None else None
    traced = None if span is None else batch_base(ctx.seed, span["batch"])
    obs = {
        "kind": "train",
        "timings": [dict(epochs_seconds=st["epochs_seconds"],
                         steps=st["epochs_run_batch"]
                         * st["steps_per_epoch_batch"],
                         batch_init_seconds=st["batch_init_seconds"])
                    for base, st in timings.items() if base != traced],
        "span": span,
        "model": model_shape(program),
    }
    by_seed = {r["experiment_seed"]: r for r in results}
    del results
    checks, readings = compare(ctx, program, csv, capture.batches, by_seed,
                               capture.steps)
    # every batch of the window had its sampled lanes compared
    checks.append(("batches_uncompared",
                   float(len(pulled) - len(capture.batches)), 0.0))
    return dict(attempted=attempted, failed=failed, e2e=e2e, obs=obs,
                checks=checks, readings=readings, memory_peak_bytes=peak,
                extra={"batches": len(pulled), "window_s": wall})


def model_shape(program: Dict) -> Dict:
    """The widths the lanes compute at."""
    return dict(k_spatial=int(sum(program["k_spatial_centers"])),
                k_temporal=int(sum(program["k_temporal_centers"])),
                hidden=[int(h) for h in program["hidden_dims"]],
                out_dim=len(program["quantile_levels"]),
                learnable=bool(program["spatial_learnable"]))


def _mismatch(a: torch.Tensor, b) -> int:
    b = torch.as_tensor(b, device=a.device)
    if tuple(a.shape) != tuple(b.shape):
        return int(max(a.numel(), b.numel()))
    return int((a != b).sum())


def hooks_missed(cb: Dict, steps: int) -> bool:
    """Whether a wrapper of `stbench/capture.py` never fired in batch `cb`:
    the program no longer calls what the comparison observes."""
    return (len(cb["losses"]) < steps or cb["grad1"] is None
            or cb["after"] is None or cb["ema_after"] is None
            or cb["val"] is None)


def compare(ctx, program: Dict, csv: Path, batches: List[Dict],
            by_seed: Dict, steps: int) -> tuple:
    """The numbers that decide `correct` (the worst over every sampled
    lane of every batch), each with its limit; with `ctx.readings` also
    each lane's readings and those of the control (the reference with
    TF32 products in the program's place)."""
    z, coords = standin.read_csv(csv)
    dev = ctx.device
    lp = program
    ks = tuple(lp["k_spatial_centers"])
    net = Net(ks, lp["k_temporal_centers"], lp["hidden_dims"],
              len(lp["quantile_levels"]), lp["spatial_learnable"],
              lp["dropout"], dev)
    names = net.names()
    limits = ctx.traffic["limits"]
    worst = {k: 0.0 for k in limits}
    missed = 0
    lanes_out = []
    for cb in batches:
        if hooks_missed(cb, steps):
            missed += 1
            continue
        for j, lane in enumerate(cb["lanes"]):
            seed = cb["seeds"][lane]
            r = by_seed.get(seed)
            view = lambda tree: {n: v[j] for n, v in tree.items()}
            masks = rdata.observation_split(z, coords, lp, seed)
            tr = rdata.points(z, coords, masks["train"])
            va = rdata.points(z, coords, masks["valid"])
            bs = rdata.batch_size(len(tr.w), lp["batch_size"])
            cap = -(-len(tr.w) // bs) * bs
            ref_train = tr.padded(cap).packed()
            ref_valid = va.padded(cb["val_cap"]).packed()
            data_mm = (_mismatch(cb["train_rows"][j], ref_train)
                       + _mismatch(cb["valid_rows"][j], ref_valid))
            params0 = net.init_weights(seed, dev)
            init = view(cb["init"])
            init_mm = sum(_mismatch(init[n], params0[n]) for n in params0)
            centers0, bws0 = cb["centers0"][j], cb["bw0"][j]
            if net.learnable:
                # the data-adaptive centers are the program's (PERF.md)
                centers, bws = centers0, bws0
                params0["basis.centers"] = init["basis.centers"]
                params0["basis.log_bandwidths"] = init["basis.log_bandwidths"]
            else:
                gc, gbw = uniform_grid(ks)
                centers = torch.as_tensor(gc, device=dev)
                bws = torch.as_tensor(gbw, device=dev)
                init_mm += (_mismatch(centers0, centers)
                            + _mismatch(bws0, bws))
            consts = {"centers": centers, "bandwidths": bws,
                      "centers0": centers}
            grad1, after = view(cb["grad1"]), view(cb["after"])
            ema_after = view(cb["ema_after"])
            vparams = view(cb["val"]["params"])
            sparams = (view(cb["serving"]) if cb["serving"] is not None
                       else None)
            lane_read = dict(batch=cb["index"], lane=lane, seed=seed,
                             data_mismatch=data_mm, init_mismatch=init_mm)
            sides = [("", f32_mm)] + (
                [("control_", tf32_mm)] if ctx.readings else [])
            ref = {tag: rtrain.follow(net, lp, params0, consts,
                                      ref_train, bs, seed, cb["seeds"][0],
                                      cb["M"], lane, steps, mm)
                   for tag, mm in sides}
            f = ref[""]
            g_norms = {n: float(torch.linalg.vector_norm(f["grad1"][n]))
                       for n in names}
            med = float(np.median(list(g_norms.values())))
            moved = [n for n in names if g_norms[n] >= 1e-3 * med]
            ref_change = {n: f["params"][n] - params0[n] for n in names}
            ref_ema = {n: f["ema"][n] - params0[n] for n in names}

            def gaps(losses, grad1, after, ema_after):
                """The compared numbers of one side against the reference:
                the first step's loss, the median leaf's first gradient
                and change (steady where a ReLU's input ties at 0), and the
                worst leaf's (a leaf left unmoved, or moved double, reads
                about 1); the later steps' losses are readings only."""
                steps_gap = [abs(a - b) / max(abs(b), 1e-12)
                             for a, b in zip(losses, f["losses"])]
                g = {n: grad1[n].to(f["grad1"][n].dtype) for n in names}
                moved_p = {n: (after[n] - params0[n]).float() for n in names}
                moved_e = {n: (ema_after[n] - params0[n]).float()
                           for n in names}
                worst_g, g_at = rtrain.leaf_gap(g, f["grad1"], names)
                worst_c = max(rtrain.leaf_gap(moved_p, ref_change, moved)[0],
                              rtrain.leaf_gap(moved_e, ref_ema, moved)[0])
                return {
                    "loss1_gap": steps_gap[0],
                    "grad_gap": rtrain.median_leaf_gap(g, f["grad1"], names),
                    "change_gap": max(
                        rtrain.median_leaf_gap(moved_p, ref_change, moved),
                        rtrain.median_leaf_gap(moved_e, ref_ema, moved)),
                    "grad_worst_gap": worst_g, "change_worst_gap": worst_c,
                    "grad_worst_at": g_at, "loss_steps": steps_gap}

            prog = gaps([float(x[j]) for x in cb["losses"]], grad1, after,
                        ema_after)
            lane_read.update(prog)
            if ctx.readings:
                lane_read["left_out"] = [n for n in names if n not in moved]
                c = ref["control_"]
                side = gaps(c["losses"], c["grad1"], c["params"], c["ema"])
                lane_read.update({"control_" + k: v for k, v in side.items()})
            # the first validation, from the program's EMA
            want = rtrain.validation(net, lp, vparams, consts, ref_valid)
            got = (float(cb["val"]["loss"][j]), float(cb["val"]["rmse"][j]))
            lane_read["val_gap"] = max(abs(a - b) / max(abs(b), 1e-12)
                                       for a, b in zip(got, want))
            if ctx.readings:
                ctl = rtrain.validation(net, lp, vparams, consts,
                                        ref_valid, tf32_mm)
                lane_read["control_val_gap"] = max(
                    abs(a - b) / max(abs(b), 1e-12) for a, b in zip(ctl, want))
            # the finalize's scores, from the program's serving parameters
            if r is None or sparams is None:
                lane_read["metrics_gap"] = math.inf
            else:
                want = rtrain.scores(net, lp, sparams, consts, z, coords,
                                     masks)
                lane_read["metrics_gap"] = _scores_gap(
                    {"train": r["metrics"]["train"],
                     "valid": r["metrics"]["valid"],
                     "test": r["metrics"]["test"]}, want)
                if ctx.readings:
                    ctl = rtrain.scores(net, lp, sparams, consts, z,
                                        coords, masks, tf32_mm)
                    lane_read["control_metrics_gap"] = _scores_gap(ctl, want)
            lanes_out.append(lane_read)
            for k in worst:
                worst[k] = max(worst[k], float(lane_read[k]))
    checks = [(k, worst[k], float(limits[k])) for k in limits]
    checks.append(("hooks_missed", float(missed), 0.0))
    return checks, lanes_out


SCORE_KEYS = ("mse", "mae", "crps", "mean_check_loss")


def _scores_gap(got: Dict, want: Dict) -> float:
    return max(abs(float(got[s][k]) - want[s][k]) / max(abs(want[s][k]),
                                                        1e-12)
               for s in want for k in SCORE_KEYS)
