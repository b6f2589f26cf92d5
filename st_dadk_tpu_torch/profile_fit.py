"""Profile the step loop of the bench-workload fit on one GPU.

    python3 -m st_dadk_tpu_torch.profile_fit [--out build/profile_fit.json]

One process sets up the bench workload (stand-in field unless
`data/2a/2a_8.csv` exists) once, then runs `train.loop.fit` for
`EPOCHS` epochs five times, each from the same initial weights and seed:

  1. a warm-up fit: the process's first launch of every kernel;
  2. `REPEATS` fits without the profiler: wall seconds and ms a step of each,
     and the spread between them;
  3. one fit under `torch.profiler`: device activities (kernels, copies,
     memsets), their summed device time, the union of their intervals, and
     the busy share = union / the wall time of that same profiled fit.

The profiler slows the host, so the busy share it reports is lower than
that of an unprofiled fit; the JSON also gives the profiled fit's wall
against the unprofiled median. Writes `--out` (JSON) and the profiler's
table beside it (`.txt`).

    python3 -m st_dadk_tpu_torch.profile_fit --lanes 1,2,4,8,16,32 \
        [--ragged] [--profile-lanes 16] [--out build/profile_lanes.json]

The width sweep of the lane engine instead: the widest batch is set up once
(`batch_engine._prepare_job_batch` on the host, then
`_init_lane_carries`: the batched spatial init and every lane's model;
seeds base_seed ..; both times are printed), and for each width
M its first M lanes run `train.loop.fit_lanes` for `EPOCHS` epochs, a
warm-up and `REPEATS` timed fits from the same initial weights. It prints
the wall ms a step (an epoch's wall over its steps, validation and
bookkeeping included; epochs 2 onwards) and that over M, beside the single
fit's `train.loop.fit` timed the same way over the same epochs, and profiles
one fit at `--profile-lanes` (default: the width with the least ms a step a
lane). At the widest width it also runs the batch's finalize evaluation
(`batch_engine._batched_eval`: one dense predict of the T x S grid for all
lanes) and records its seconds and its peak device memory, since a chunk's
activations grow with the lane count, beside the same lanes scored by the
device metrics (`batch_engine._batched_eval_device`, which a batch with no
artifacts or figures takes). `batch_engine.LANES_PER_DEVICE` takes
the width this sweep finds best. With `--ragged` the lanes alternate between
the resolutions [25, 81] and [25, 81, 121], padded to 227 centers: ragged-k
lanes on the materialised-phi route, whose single fit is the padded lane.

    python3 -m st_dadk_tpu_torch.profile_fit --lanes 1,16,64,128 \
        --train_dtype f32,bf16 [--packed] [--compaction] \
        [--hidden 512,512,256] [--out build/profile_modes.json]

The width sweep over the fit's arithmetic options instead: each mode (a
trunk dtype of `--train_dtype`; `--packed`: `packed_optimizer` on the
float32 trunk; `--compaction`: two modes at patience COMPACT_PATIENCE,
'stop' without and 'compaction' with `tail_compaction` at epoch
COMPACT_EPOCH) runs at every width from the same lanes and initial
weights: a warm-up of each, then `REPEATS` rounds in which every mode fits
once in turn, so that each round pairs the modes within a few seconds
(ms a step and its ratio to the first mode, per round); then every mode is
profiled at every width (device ms, device activities and busy share a
step). `--hidden` sets the trunk's widths (the size trigger of `auto`).

    python3 -m st_dadk_tpu_torch.profile_fit --init 4,16,128 \
        [--out build/profile_init.json]

The spatial init instead: the widest batch of bench-workload lanes is set up
on the host once, then for each init method ('kmeans_balanced',
'random_site', 'gmm', 'kmeans_exact': the host solver, a batch lane by lane)
and width M the first M lanes are initialised as one
batch (`init_spatial_centers_batch`, a warm-up and `REPEATS` timed runs, each
lane from fresh copies of its streams) with the batch's peak device memory,
and the first `INIT_LANE_BY_LANE` lanes one at a time (`init_spatial_centers`).
One batched balanced k-means of the narrowest width and one lane alone run
under `torch.profiler`: their device activities (the Sinkhorn iterations are
plain PyTorch operations) and device time.
"""
from __future__ import annotations

import argparse
import copy
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
EPOCHS = 12       # the fit chip_smoke.py runs: the basis trains from epoch 10
REPEATS = 3
# the compaction modes of the width sweep: lanes stop after this many epochs
# without a validation gain, and the batch narrows at this epoch
COMPACT_PATIENCE, COMPACT_EPOCH = 1, 4
INIT_LANE_BY_LANE = 4
INIT_METHODS = ("kmeans_balanced", "random_site", "gmm", "kmeans_exact")
# a csrc kernel's demangled name: "(anonymous namespace)::bwd_w_kernel(...)",
# "void (anonymous namespace)::fwd_kernel<16, 64, ...>(...)" (a template),
# "st_slabs::centers_sum_kernel(...)" (csrc/slabs.cuh),
# "(anonymous namespace)::lane_adamw_kernel(...)" (csrc/lane_optimizer.cu)
PORT_KERNEL = re.compile(
    r"(?:void )?(?:\(anonymous namespace\)|st_slabs)::"
    r"((?:fwd|bwd_w|bwd_centers|bwd_points|slab_sum|centers_sum|lane_clip_sumsq"
    r"|lane_clip_scale|lane_adamw|lane_ema)_kernel)[<(]")


def _timed_fit(loop, cfg, setup, init_state, seed):
    setup.model.load_state_dict(init_state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = loop.fit(cfg, setup.spec, setup.model, setup.train_ps,
                   setup.valid_ps, seed=seed)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def _per_step(res):
    """ms a step over the whole fit, in epoch 1 and in epochs 2 onwards."""
    t, first = (res.timings["train_steps_seconds"],
                res.timings["first_epoch_steps_seconds"])
    per_epoch = res.n_steps // res.n_epochs_run
    return {"ms_per_step": 1e3 * t / res.n_steps,
            "epoch1_ms_per_step": 1e3 * first / per_epoch,
            "later_ms_per_step": 1e3 * (t - first) / (res.n_steps - per_epoch)}


def _union_us(intervals):
    """Total length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def _device_profile(prof, steps):
    """Device activities of a profiled run: their count, summed device ms,
    the union of their intervals, the 12 largest by name, and the port's
    own kernels (csrc/*.cu and the slab sums of csrc/slabs.cuh), by function
    name (template arguments dropped), in device ms a step."""
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time / 1e3
    ours = {}
    for name, ms in by_name.items():
        m = PORT_KERNEL.match(name)
        if m:
            ours[m.group(1)] = ours.get(m.group(1), 0.0) + ms / steps
    return {"activities": len(dev),
            "device_ms": sum(e.device_time for e in dev) / 1e3,
            "busy_ms": _union_us([(e.time_range.start, e.time_range.end)
                                  for e in dev]) / 1e3,
            "top": sorted(by_name.items(), key=lambda kv: -kv[1])[:12],
            "ours": ours}


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


RAGGED_GRID, RAGGED_PAD = ([25, 81], [25, 81, 121]), 227


def sweep_modes(train_dtypes: str, packed: bool, compaction: bool
                ) -> dict:
    """{mode: config overrides} of the width sweep (module docstring)."""
    modes = {dt: {"train_dtype": dt} for dt in train_dtypes.split(",")}
    if packed:
        modes["packed"] = {"train_dtype": "f32", "packed_optimizer": True}
    if compaction:
        modes["stop"] = {"train_dtype": "f32", "patience": COMPACT_PATIENCE}
        modes["compaction"] = dict(modes["stop"], tail_compaction=True,
                                   compaction_epoch=COMPACT_EPOCH)
    return modes


def lanes_sweep(widths, profile_width, out: Path, ragged: bool = False,
                modes=None, hidden=None, repeats=REPEATS) -> int:
    """The lane engine's width sweep (module docstring). With `ragged`
    the lanes alternate between the resolutions of RAGGED_GRID, padded to
    RAGGED_PAD centers: the materialised-phi route's lane kernels. With
    `modes` ({name: config overrides}) every width runs every mode in
    paired rounds and profiles each; `hidden` sets the trunk's widths."""
    if modes is not None:
        return modes_sweep(widths, out, ragged, modes, hidden, repeats)
    from torch.profiler import ProfilerActivity, profile

    from st_dadk_tpu_torch.bench_workload import bench_workload
    from st_dadk_tpu_torch.config import ExperimentConfig
    from st_dadk_tpu_torch.dataio.synthetic import bench_data_file
    from st_dadk_tpu_torch.models.st_interp import (from_jax_params,
                                                    model_consts,
                                                    stack_lane_models)
    from st_dadk_tpu_torch.train import batch_engine as be
    from st_dadk_tpu_torch.train import loop

    card = _card()
    print(f"card: {card}", flush=True)
    cfg = ExperimentConfig.from_dict(bench_workload(
        data_file=str(bench_data_file()), epochs=EPOCHS,
        n_experiments=max(widths)))
    lane_cfgs = [cfg.replace(k_spatial_centers=RAGGED_GRID[i % 2],
                             k_spatial_pad=RAGGED_PAD) if ragged else cfg
                 for i in range(max(widths))]
    cfg = lane_cfgs[0]
    t0 = time.perf_counter()
    prep = be._prepare_job_batch(
        [(c, i + 1, REPO / "build" / "profile_lanes" / str(i + 1))
         for i, c in enumerate(lane_cfgs)], device="cuda")
    setups = prep["setups"]
    t1 = time.perf_counter()
    be._init_lane_carries(cfg, setups)      # every lane's model, init batched
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    print(f"set up {len(setups)} lanes in {setup_s:.1f} s (host "
          f"{t1 - t0:.1f} s; batched spatial init and models "
          f"{setup_s - (t1 - t0):.1f} s, init a lane "
          f"{statistics.median(s.timings['init_seconds'] for s in setups):.3f}"
          f" s median)", flush=True)

    def _later_ms(tm, B):
        """ms a step in epochs 2 onwards: the loop's wall over its steps."""
        return 1e3 * ((tm["epochs_seconds"] - tm["first_epoch_seconds"])
                      / ((EPOCHS - 1) * B))

    def lane_fit(m):
        """One fit of the first m lanes: (wall s, ms a step in epochs 2
        onwards, steps an epoch, the lanes' FitResults)."""
        stacked = be._stack_lane_host(cfg, setups[:m], prep["device"])
        model = stack_lane_models([s.model for s in setups[:m]])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = loop.fit_lanes(cfg, setups[0].spec, model, stacked["data"],
                             stacked["lr_steps"], stacked["lr_recorded"],
                             [s.experiment_seed for s in setups[:m]])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tm = res[0].timings
        B = int(tm["steps_per_epoch_batch"])
        return wall, _later_ms(tm, B), B, res

    # the single fit, timed the same way: a warm-up fit, then the loop's
    # wall over its steps in epochs 2 onwards
    single = setups[0]
    init_state = copy.deepcopy(single.model.state_dict())
    single_ms = []
    for _ in range(1 + REPEATS):
        res, _ = _timed_fit(loop, cfg, single, init_state,
                            single.experiment_seed)
        single_ms.append(_later_ms(res.timings,
                                   res.n_steps // res.n_epochs_run))
    single.model.load_state_dict(init_state)
    single_ms = statistics.median(single_ms[1:])
    print(f"single fit (train.loop.fit): {single_ms:.3f} ms a step in epochs "
          f"2-{EPOCHS}, validation included (median of {REPEATS})", flush=True)

    rows = []
    for m in widths:
        lane_fit(m)                                        # warm-up
        runs = [lane_fit(m) for _ in range(REPEATS)]
        ms = statistics.median(r[1] for r in runs)
        wall = statistics.median(r[0] for r in runs)
        rows.append({"lanes": m, "ms_per_step": ms,
                     "ms_per_step_per_lane": ms / m, "fit_wall_s": wall,
                     "ms_per_step_runs": [r[1] for r in runs],
                     "steps_per_epoch": runs[0][2],
                     "single_fits_ms_per_step_per_lane": single_ms})
        print(f"M={m:3d}: {ms:8.3f} ms a step (runs "
              f"{', '.join(f'{r[1]:.3f}' for r in runs)}), {ms / m:7.3f} ms a "
              f"step a lane ({single_ms * m / ms:.2f}x {m} single fits), "
              f"{EPOCHS}-epoch fit wall {wall:.3f} s", flush=True)
    best = min(rows, key=lambda r: r["ms_per_step_per_lane"])["lanes"]
    print(f"least ms a step a lane at M={best}", flush=True)

    # the batch's finalize evaluation at the widest width: one dense
    # predict of the T x S grid for all lanes
    wide = max(widths)
    fits = lane_fit(wide)[3]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    be._batched_eval(cfg, setups[:wide], fits)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    eval_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"finalize evaluation of {wide} lanes (one dense predict of "
          f"{setups[0].T} x {setups[0].S} points a lane, chunks of "
          f"{cfg.eval_chunk}): {eval_s:.3f} s, peak device memory "
          f"{eval_gib:.3f} GiB", flush=True)
    # the same lanes through the device metrics (`_batched_eval_device`),
    # their serving params already on the card as `fit_lanes` leaves them;
    # twice, each call uploading the grid, as every batch's finalize does
    serving = stack_lane_models([
        from_jax_params(s.spec, f.params, model_consts(s.model),
                        device="cuda") for s, f in zip(setups[:wide], fits)])
    params = {k: v.detach() for k, v in serving.named_parameters()}
    device_eval = []
    for _ in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        be._batched_eval_device(cfg, setups[:wide], serving, params)
        torch.cuda.synchronize()
        device_eval.append({"seconds": time.perf_counter() - t0,
                            "peak_device_memory_gib":
                                torch.cuda.max_memory_allocated() / 2 ** 30})
    print("the same through the device metrics: "
          + ", ".join(f"{d['seconds']:.3f} s (peak "
                      f"{d['peak_device_memory_gib']:.3f} GiB)"
                      for d in device_eval)
          + " (first call, then a second)", flush=True)

    m = profile_width or best
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_wall, _, B, _ = lane_fit(m)
    steps = EPOCHS * B
    d = _device_profile(prof, steps)
    report = {"card": card, "epochs": EPOCHS, "single_fit_ms_per_step":
              single_ms, "setup_lanes": len(setups), "setup_seconds": setup_s,
              "widths": rows, "least_ms_per_step_per_lane_at": best,
              "finalize_eval": {"lanes": wide, "seconds": eval_s,
                                "peak_device_memory_gib": eval_gib,
                                "device_metrics": device_eval},
              "profiled": {
                  "lanes": m, "wall_s": prof_wall,
                  "device_activities_per_step": d["activities"] / steps,
                  "device_ms_per_step": d["device_ms"] / steps,
                  "busy_ms": d["busy_ms"],
                  "busy_share": d["busy_ms"] / (1e3 * prof_wall),
                  "top_device_ms": d["top"],
                  "port_kernels_ms_per_step": d["ours"]}}
    p = report["profiled"]
    print(f"profiled fit at M={m}: {prof_wall:.4f} s wall, "
          f"{p['device_activities_per_step']:.1f} device activities a step "
          f"incl. validation, {p['device_ms_per_step']:.4f} ms device time a "
          f"step, busy {d['busy_ms']:.3f} ms = share {p['busy_share']:.4f} "
          f"of the same fit's wall", flush=True)
    for name, ms in d["top"]:
        print(f"  {ms:9.3f} ms  {name[:90]}")
    print("the port's kernels, device ms a step: " + ", ".join(
        f"{k} {v:.5f}" for k, v in sorted(d["ours"].items())), flush=True)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    print(f"wrote {out}", flush=True)
    return 0


def modes_sweep(widths, out: Path, ragged: bool, modes: dict,
                hidden=None, repeats=REPEATS) -> int:
    """The width sweep over the fit's arithmetic options (module
    docstring)."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from st_dadk_tpu_torch.bench_workload import bench_workload
    from st_dadk_tpu_torch.config import ExperimentConfig
    from st_dadk_tpu_torch.dataio.synthetic import bench_data_file
    from st_dadk_tpu_torch.models.st_interp import (resolve_train_dtype,
                                                    stack_lane_models)
    from st_dadk_tpu_torch.train import batch_engine as be
    from st_dadk_tpu_torch.train import loop

    card = _card()
    print(f"card: {card}", flush=True)
    over = {} if hidden is None else {"hidden_dims": list(hidden)}
    cfg = ExperimentConfig.from_dict(bench_workload(
        data_file=str(bench_data_file()), epochs=EPOCHS,
        n_experiments=max(widths), train_dtype="f32", **over))
    lane_cfgs = [cfg.replace(k_spatial_centers=RAGGED_GRID[i % 2],
                             k_spatial_pad=RAGGED_PAD) if ragged else cfg
                 for i in range(max(widths))]
    cfg = lane_cfgs[0]
    t0 = time.perf_counter()
    prep = be._prepare_job_batch(
        [(c, i + 1, REPO / "build" / "profile_modes" / str(i + 1))
         for i, c in enumerate(lane_cfgs)], device="cuda")
    setups = prep["setups"]
    be._init_lane_carries(cfg, setups)
    torch.cuda.synchronize()
    print(f"set up {len(setups)} lanes (hidden {list(cfg.hidden_dims)}) in "
          f"{time.perf_counter() - t0:.1f} s; modes: {modes}", flush=True)

    def lane_fit(m, name):
        """One fit of the first m lanes in mode `name`: (wall s, ms a step
        in epochs 2 onwards of those run, steps an epoch, epochs run)."""
        cfg_m = cfg.replace(**modes[name])
        spec = dataclasses.replace(setups[0].spec,
                                   compute_dtype=resolve_train_dtype(cfg_m))
        stacked = be._stack_lane_host(cfg_m, setups[:m], prep["device"])
        model = stack_lane_models([s.model for s in setups[:m]])
        model.spec = spec
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = loop.fit_lanes(cfg_m, spec, model, stacked["data"],
                             stacked["lr_steps"], stacked["lr_recorded"],
                             [s.experiment_seed for s in setups[:m]],
                             verbose=name == "compaction")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tm = res[0].timings
        B, ran = int(tm["steps_per_epoch_batch"]), int(tm["epochs_run_batch"])
        later = 1e3 * ((tm["epochs_seconds"] - tm["first_epoch_seconds"])
                       / (max(ran - 1, 1) * B))
        return wall, later, B, ran, [r.n_epochs_run for r in res]

    names = list(modes)
    rows = []
    for m in widths:
        for name in names:
            lane_fit(m, name)                                  # warm-up
        rounds = [{name: lane_fit(m, name) for name in names}
                  for _ in range(repeats)]
        row = {"lanes": m, "modes": {}}
        base = names[0]
        for name in names:
            ms = [r[name][1] for r in rounds]
            ratio = [r[name][1] / r[base][1] for r in rounds]
            row["modes"][name] = {
                "ms_per_step": statistics.median(ms), "ms_per_step_runs": ms,
                "ratio_to_" + base + "_runs": ratio,
                "pairs_below_1": sum(x < 1.0 for x in ratio),
                "fit_wall_s": statistics.median(r[name][0] for r in rounds),
                "epochs_run": rounds[0][name][3],
                "lane_stop_epochs": rounds[0][name][4]}
            print(f"M={m:3d} {name:>10s}: {statistics.median(ms):8.3f} ms a "
                  f"step (runs {', '.join(f'{x:.3f}' for x in ms)}; / {base} "
                  f"{', '.join(f'{x:.4f}' for x in ratio)}), epochs run "
                  f"{rounds[0][name][3]}", flush=True)
        for name in names:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                wall, _, B, ran, _ = lane_fit(m, name)
            steps = ran * B
            d = _device_profile(prof, steps)
            row["modes"][name]["profiled"] = {
                "wall_s": wall,
                "device_activities_per_step": d["activities"] / steps,
                "device_ms_per_step": d["device_ms"] / steps,
                "busy_share": d["busy_ms"] / (1e3 * wall),
                "port_kernels_ms_per_step": d["ours"]}
            p = row["modes"][name]["profiled"]
            print(f"M={m:3d} {name:>10s} profiled: "
                  f"{p['device_activities_per_step']:.1f} device activities "
                  f"a step incl. validation, {p['device_ms_per_step']:.4f} ms "
                  f"device time a step, busy share {p['busy_share']:.4f}",
                  flush=True)
        rows.append(row)
    report = {"card": card, "epochs": EPOCHS, "hidden_dims":
              list(cfg.hidden_dims), "ragged": ragged, "modes": modes,
              "widths": rows}
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    print(f"wrote {out}", flush=True)
    return 0


def init_sweep(widths, out: Path) -> int:
    """Seconds a lane of each init method, batched and lane by lane, peak
    memory a batch, and the balanced k-means' device activities (module
    docstring)."""
    from torch.profiler import ProfilerActivity, profile

    from st_dadk_tpu_torch.bench_workload import bench_workload
    from st_dadk_tpu_torch.config import ExperimentConfig
    from st_dadk_tpu_torch.dataio.synthetic import bench_data_file
    from st_dadk_tpu_torch.ops import init_centers as ic
    from st_dadk_tpu_torch.train import batch_engine as be

    card = _card()
    print(f"card: {card}", flush=True)
    cfg = ExperimentConfig.from_dict(bench_workload(
        data_file=str(bench_data_file()), n_experiments=max(widths)))
    setups = be._prepare_job_batch(
        [(cfg, i + 1, REPO / "build" / "profile_init" / str(i + 1))
         for i in range(max(widths))], device="cuda")["setups"]
    ks = list(cfg.k_spatial_centers)
    n_pts = min(len(setups[0].train_ps.coords), ic.MAX_INIT_SAMPLES)

    def streams(lanes):
        return ([torch.Generator(device="cuda").manual_seed(s.experiment_seed)
                 for s in lanes], [copy.deepcopy(s.np_rng) for s in lanes])

    def batched(method, m):
        gens, rngs = streams(setups[:m])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ic.init_spatial_centers_batch(
            method, ks, [s.train_ps.coords for s in setups[:m]], gens, rngs,
            "cuda")
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def lane_by_lane(method, m):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for s in setups[:m]:
            (gen,), (rng,) = streams([s])
            ic.init_spatial_centers(method, ks, s.train_ps.coords,
                                    generator=gen, device="cuda", rng=rng)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    rows = []
    for method in INIT_METHODS:
        batched(method, min(widths))                       # warm-up
        one = [lane_by_lane(method, INIT_LANE_BY_LANE) / INIT_LANE_BY_LANE
               for _ in range(REPEATS)]
        for m in widths:
            torch.cuda.reset_peak_memory_stats()
            secs = [batched(method, m) / m for _ in range(REPEATS)]
            rows.append({"method": method, "lanes": m,
                         "batched_s_per_lane": statistics.median(secs),
                         "batched_runs": secs,
                         "lane_by_lane_s_per_lane": statistics.median(one),
                         "lane_by_lane_runs": one,
                         "peak_device_memory_gib":
                             torch.cuda.max_memory_allocated() / 2 ** 30})
            r = rows[-1]
            print(f"{method:16s} M={m:3d}: batched {r['batched_s_per_lane']:.4f}"
                  f" s a lane (runs {', '.join(f'{x:.4f}' for x in secs)}), "
                  f"lane by lane {r['lane_by_lane_s_per_lane']:.4f} s a lane "
                  f"(first {INIT_LANE_BY_LANE} lanes), peak memory "
                  f"{r['peak_device_memory_gib']:.3f} GiB", flush=True)

    profiled = {}
    for name, fn in (("batched", lambda: batched("kmeans_balanced",
                                                 min(widths))),
                     ("one lane", lambda: lane_by_lane("kmeans_balanced", 1))):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall = fn()
        d = _device_profile(prof, 1)
        profiled[name] = {"lanes": min(widths) if name == "batched" else 1,
                          "wall_s": wall, "device_activities": d["activities"],
                          "device_ms": d["device_ms"], "busy_ms": d["busy_ms"],
                          "top_device_ms": d["top"]}
        print(f"kmeans_balanced {name} ({profiled[name]['lanes']} lanes) under "
              f"the profiler: {d['activities']} device activities, "
              f"{d['device_ms']:.3f} ms device time, busy {d['busy_ms']:.3f} "
              f"ms of {1e3 * wall:.3f} ms wall", flush=True)
    report = {"card": card, "resolutions": ks, "points_a_lane": n_pts,
              "rows": rows, "kmeans_balanced_profiled": profiled}
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    print(f"wrote {out}", flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--lanes", default=None,
                    help="comma-separated lane widths: run the lane "
                         "engine's width sweep instead of the single fit")
    ap.add_argument("--profile-lanes", type=int, default=None,
                    help="the width profiled in the sweep (default: the "
                         "one with the least ms a step a lane)")
    ap.add_argument("--ragged", action="store_true",
                    help="with --lanes: ragged-k lanes (the materialised-phi "
                         "route), resolutions alternating, padded to one "
                         "width")
    ap.add_argument("--init", default=None,
                    help="comma-separated lane widths: time the spatial "
                         "init methods instead of a fit")
    ap.add_argument("--train_dtype", default="f32",
                    help="comma-separated trunk dtypes (f32, bf16, auto); "
                         "one: the fit's, several (with --lanes): modes")
    ap.add_argument("--packed", action="store_true",
                    help="packed_optimizer: a mode of its own with --lanes "
                         "and another mode, else the fit's")
    ap.add_argument("--compaction", action="store_true",
                    help="with --lanes: the 'stop' and 'compaction' modes")
    ap.add_argument("--repeats", type=int, default=REPEATS,
                    help="with the modes of --lanes: paired rounds a width")
    ap.add_argument("--hidden", default=None,
                    help="comma-separated hidden widths (default: the "
                         "bench's 256,256,128)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_fit: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.init:
        return init_sweep([int(x) for x in args.init.split(",")],
                          args.out or REPO / "build" / "profile_init.json")
    hidden = (None if args.hidden is None
              else [int(x) for x in args.hidden.split(",")])
    use_modes = (args.train_dtype != "f32" or args.packed or args.compaction
                 or hidden is not None)
    if args.lanes:
        return lanes_sweep([int(x) for x in args.lanes.split(",")],
                           args.profile_lanes,
                           args.out or REPO / "build" / "profile_lanes.json",
                           ragged=args.ragged, hidden=hidden,
                           repeats=args.repeats,
                           modes=(sweep_modes(args.train_dtype, args.packed,
                                              args.compaction)
                                  if use_modes else None))
    if "," in args.train_dtype or args.compaction:
        ap.error("several trunk dtypes and --compaction need --lanes")
    args.out = args.out or REPO / "build" / "profile_fit.json"

    from torch.profiler import ProfilerActivity, profile

    from st_dadk_tpu_torch.bench_workload import bench_workload
    from st_dadk_tpu_torch.config import ExperimentConfig
    from st_dadk_tpu_torch.dataio.synthetic import bench_data_file
    from st_dadk_tpu_torch.train import loop
    from st_dadk_tpu_torch.train.experiment import ExperimentSetup

    card = _card()
    print(f"card: {card}", flush=True)
    cfg = ExperimentConfig.from_dict(bench_workload(
        data_file=str(bench_data_file()), epochs=EPOCHS,
        train_dtype=args.train_dtype, packed_optimizer=args.packed,
        **({} if hidden is None else {"hidden_dims": hidden})))
    setup = ExperimentSetup(cfg, 1, "cuda")
    init_state = copy.deepcopy(setup.model.state_dict())
    seed = setup.experiment_seed

    res, wall = _timed_fit(loop, cfg, setup, init_state, seed)
    steps = res.n_steps
    warm = {"wall_s": wall, **_per_step(res)}
    runs = []
    for i in range(REPEATS):
        res, wall = _timed_fit(loop, cfg, setup, init_state, seed)
        runs.append({"wall_s": wall, **_per_step(res)})
    for name, r in [("warm-up fit", warm)] + [(f"fit {i + 1}", r) for i, r
                                              in enumerate(runs)]:
        print(f"{name}: {r['wall_s']:.4f} s, {r['ms_per_step']:.3f} ms a step"
              f" (epoch 1 {r['epoch1_ms_per_step']:.3f}, epochs 2-{EPOCHS} "
              f"{r['later_ms_per_step']:.3f}; {steps} steps)", flush=True)
    walls = [r["wall_s"] for r in runs]

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res, prof_wall = _timed_fit(loop, cfg, setup, init_state, seed)
    d = _device_profile(prof, steps)
    dev_ms, busy_ms, top, ours = (d["device_ms"], d["busy_ms"], d["top"],
                                  d["ours"])
    n_dev = d["activities"]

    report = {
        "card": card, "epochs": EPOCHS, "steps": steps,
        "warmup_fit": warm, "fits": runs,
        "wall_s_median": statistics.median(walls),
        "wall_s_spread": (max(walls) - min(walls)) / statistics.median(walls),
        "profiled": {
            "wall_s": prof_wall,
            "wall_vs_unprofiled_median": prof_wall / statistics.median(walls),
            "device_activities": n_dev,
            "device_activities_per_step": n_dev / steps,
            "device_ms": dev_ms, "device_ms_per_step": dev_ms / steps,
            "busy_ms": busy_ms,
            "busy_share": busy_ms / (1e3 * prof_wall),
            "top_device_ms": top,
            "port_kernels_ms_per_step": ours,
        },
    }
    p = report["profiled"]
    print(f"profiled fit: {prof_wall:.4f} s wall "
          f"({p['wall_vs_unprofiled_median']:.3f}x the unprofiled median), "
          f"{n_dev} device activities "
          f"({p['device_activities_per_step']:.1f} a step incl. validation), "
          f"{dev_ms:.3f} ms device time ({p['device_ms_per_step']:.4f} ms a "
          f"step), busy {busy_ms:.3f} ms = share {p['busy_share']:.4f} of "
          f"the same fit's wall", flush=True)
    for name, ms in top:
        print(f"  {ms:9.3f} ms  {name[:90]}")
    print("the port's kernels, device ms a step: " + ", ".join(
        f"{k} {v:.5f}" for k, v in sorted(ours.items())), flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(report, indent=1))
    args.out.with_suffix(".txt").write_text(prof.key_averages().table(
        sort_by="self_device_time_total", row_limit=25))
    print(f"wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
