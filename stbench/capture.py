"""Observation of the program's training entry, for the comparison that
decides `correct` and for the traced span: thin wrappers around seven of
the program's functions that call the original and keep copies, on the
device, of what it computed for a few sampled lanes of each batch. They
change nothing the program computes.

    batch_engine.fit_lanes        a batch's start state (parameters, basis,
                                  training and validation rows) and, after
                                  the fit, its serving parameters
    loop.lane_losses_from_preds   the losses of the first `steps` steps
    AdamWLanes.step               the first step's gradients as the
                                  optimizer gets them; the parameters after
                                  the last followed step
    loop.ema_update_lanes         the EMA after the last followed step
    loop._validate_lanes          the EMA the first validation reads and
                                  its returned loss and RMSE; the epoch
                                  clock of the traced span
    fused_first_layer._count,     the kernel launches by shape inside the
    spatial_basis_kernels._count  traced span

Only batches run while `active` is set are observed (the window's, not the
warm-up's). A wrapper that never fires leaves its record empty: the driver
counts such a batch as not compared (`hooks_missed`), and a traced run
whose span never opened prints no result (`stbench/run.py`), so a change to
these functions of the program shows and the yardstick never goes dark
unnoticed.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch


class Capture:
    def __init__(self, pick: Callable[[Sequence[int]], List[int]],
                 steps: int = 3):
        self.pick, self.steps = pick, int(steps)
        self.active = False
        self.batches: List[Dict] = []
        self.cur: Optional[Dict] = None
        self.span = None            # trace.Span, in a traced run
        self.span_batch = 1         # the window's batch the span opens in
        self.span_epochs = (20, 5)  # (epochs before it opens, epochs in it)
        self._undo: List = []

    # -- install ---------------------------------------------------------
    def install(self) -> "Capture":
        from st_dadk_tpu_torch.ops import fused_first_layer as ffl
        from st_dadk_tpu_torch.ops import spatial_basis_kernels as sbk
        from st_dadk_tpu_torch.train import batch_engine, loop, optimizer

        def patch(obj, name, make):
            orig = getattr(obj, name)
            setattr(obj, name, make(orig))
            self._undo.append((obj, name, orig))

        patch(batch_engine, "fit_lanes", self._fit_lanes)
        patch(loop, "lane_losses_from_preds", self._losses)
        patch(optimizer.AdamWLanes, "step", self._step)
        patch(loop, "ema_update_lanes", self._ema)
        patch(loop, "_validate_lanes", self._validate)
        patch(ffl, "_count", self._count)
        patch(sbk, "_count", self._count_basis)
        return self

    def uninstall(self) -> None:
        for obj, name, orig in reversed(self._undo):
            setattr(obj, name, orig)
        self._undo.clear()

    # -- wrappers --------------------------------------------------------
    def _fit_lanes(self, orig):
        def fit_lanes(cfg, spec_model, model, data, lr_steps, lr_recorded,
                      seeds, *args, **kwargs):
            if not self.active:
                return orig(cfg, spec_model, model, data, lr_steps,
                            lr_recorded, seeds, *args, **kwargs)
            lanes = list(self.pick(list(seeds)))
            idx = torch.as_tensor(lanes, device=data.packed_tr.device)
            take = lambda t: t.detach()[idx].clone()
            cur = dict(
                index=len(self.batches), seeds=[int(s) for s in seeds],
                lanes=lanes, M=len(seeds), bs=int(data.batch_size),
                B=int(data.B_shared), val_cap=int(data.va_coords.shape[1]),
                names={id(p): n for n, p in model.named_parameters()},
                init={n: take(p) for n, p in model.named_parameters()},
                centers0=take(model.spatial_centers_init),
                bw0=take(model.spatial_bandwidths_init),
                train_rows=take(data.packed_tr),
                valid_rows=take(torch.cat([data.va_coords, data.va_t,
                                           data.va_y, data.va_w[..., None]],
                                          dim=-1)),
                losses=[], step=0, grad1=None, after=None, ema_after=None,
                val=None, epochs=0, take=take)
            self.cur = cur
            try:
                results = orig(cfg, spec_model, model, data, lr_steps,
                               lr_recorded, seeds, *args, **kwargs)
            finally:
                self.cur = None
            serving = kwargs.get("serving_out")
            if serving and "params" in serving:
                cur["serving"] = {n: take(v)
                                  for n, v in serving["params"].items()}
            else:
                cur["serving"] = None
            del cur["take"], cur["names"]
            self.batches.append(cur)
            return results
        return fit_lanes

    def _losses(self, orig):
        def lane_losses_from_preds(spec, model, preds, y, w, *args, **kwargs):
            out = orig(spec, model, preds, y, w, *args, **kwargs)
            train = kwargs.get("train", args[0] if args else False)
            c = self.cur
            if c is not None and train and len(c["losses"]) < self.steps:
                c["losses"].append(c["take"](out))
            return out
        return lane_losses_from_preds

    def _step(self, orig):
        capture = self

        def step(opt, lrs, executes):
            c = capture.cur
            if c is not None and c["step"] < capture.steps:
                params = [p for ps in opt.groups.values() for p in ps]
                if any(id(p) not in c["names"] for p in params):
                    raise RuntimeError("the comparison follows unpacked "
                                       "parameters: packed_optimizer off")
                if c["step"] == 0:
                    c["grad1"] = {c["names"][id(p)]: c["take"](p.grad)
                                  for p in params}
                orig(opt, lrs, executes)
                c["step"] += 1
                if c["step"] == capture.steps:
                    c["after"] = {c["names"][id(p)]: c["take"](p)
                                  for p in params}
                return
            orig(opt, lrs, executes)
        return step

    def _ema(self, orig):
        def ema_update_lanes(ema, params, *args, **kwargs):
            orig(ema, params, *args, **kwargs)
            c = self.cur
            if c is not None and c["step"] == self.steps \
                    and c["ema_after"] is None:
                c["ema_after"] = {c["names"][id(p)]: c["take"](e)
                                  for e, p in zip(ema, params)}
        return ema_update_lanes

    def _validate(self, orig):
        def _validate_lanes(spec, ema, data, *args, **kwargs):
            c = self.cur
            first = c is not None and c["val"] is None
            if first:
                ema_params = {n: c["take"](p)
                              for n, p in ema.named_parameters()}
            out = orig(spec, ema, data, *args, **kwargs)
            if c is None:
                return out
            if first:
                c["val"] = dict(params=ema_params, loss=c["take"](out[0]),
                                rmse=c["take"](out[1]))
            c["epochs"] += 1
            span = self.span
            if span is not None and c["index"] == self.span_batch:
                before, n = self.span_epochs
                if c["epochs"] == before:
                    span.extra.update(batch=c["index"], epochs=n, M=c["M"],
                                      B=c["B"], bs=c["bs"],
                                      val_cap=c["val_cap"])
                    span.start()
                elif c["epochs"] == before + n and not span.closed:
                    span.stop()
            return out
        return _validate_lanes

    def _count(self, orig):
        def _count(fn, lead, n, k, h, basis_id):
            orig(fn, lead, n, k, h, basis_id)
            if self.span is not None:
                self.span.count(fn.__name__, lead, n, k, h)
        return _count

    def _count_basis(self, orig):
        def _count(fn, lead, n, k, mask, basis_id):
            orig(fn, lead, n, k, mask, basis_id)
            if self.span is not None:
                self.span.count(fn.__name__, lead, n, k, 0)
        return _count
