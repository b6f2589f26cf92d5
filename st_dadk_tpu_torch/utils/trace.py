"""The port's one tracer: spans of the program's own work, on the clock
torch.profiler's Chrome trace stamps with.

    from st_dadk_tpu_torch.utils import trace
    trace.enable()
    ...                                  # the program runs
    trace.disable()
    rec = trace.drain()                  # {"spans", "thread", ...}

Off by default. Switched by `enable()` / `disable()` only; `drain()` hands
over what was recorded since the last drain and forgets it. Nothing is
written anywhere: whoever drains the record keeps it.

Spans. `with span(name, **ids):` records the name, the start and end, the
thread (`threading.get_native_id()`), the enclosing span of the same thread
(its `parent`) and the ids (`batch`, `epoch`, `request`, ...), which a span
inherits from its parent, so that every span of one batch or one request
carries its id. A span records only if the tracer was on when it opened.
Off, `span` costs one test of a module flag and returns a shared object
that does nothing: no clock read, no object made.

`stage(name, **ids)` is a span that always takes its two clock reads,
exposes them (`t0`, `t1`, `seconds`, on `time.perf_counter_ns`'s clock) and
always sits on its thread's stack of spans: the batch pipeline's stages
build the results' `stage_timings` from them, traced or not.

Clock. Stamps are `time.perf_counter_ns()` (CLOCK_MONOTONIC). `enable()`
reads one (perf_counter_ns, time_ns) pair back to back, and `drain()`
returns every stamp on `time.time_ns()`'s clock (CLOCK_REALTIME): a Chrome
trace of torch.profiler stamps its events `ts` in microseconds from its
`baseTimeNanoseconds` on that clock. The two clocks slew together, so one
anchor a session holds their offset.

Threads. Spans may be recorded from any thread (the batch pipeline's
prepare and finalize threads record beside the main thread): closed spans
are added under one lock; a span's parent is the innermost open span of
its own thread. `trace_steady_state.py` reads a drained record against a
device trace: the device's idle time by the innermost span of each
thread.

Span names by layer:

    batch pipeline   batch.prepare (prepare thread), batch.wait_prepare,
    (batch_engine)   batch.execute > batch.upload, batch.init > init.centers,
                     init.models; fit; batch.wait_finalize (main thread),
                     batch.finalize > finalize.eval, finalize.write
                     (finalize thread); ids: batch
    lane engine      fit.epoch > fit.shuffle, fit.step > step.forward,
    (loop.fit_lanes) step.backward, step.optimizer; fit.validate,
                     fit.bookkeeping > fit.host_read; fit.compaction;
                     ids: epoch
    single fit       fit.epoch > fit.step
    predict          predict.request > predict.copy_in, predict.forward (a
    (loop.predict,   chunk each), predict.gather; ids: request
    predict_lanes)
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Dict, List

_on = False
_lock = threading.Lock()
_local = threading.local()
_seq = itertools.count(1)
_records: List[tuple] = []          # closed spans (name, t0, t1, thread,
                                    # id, parent, ids)
_session: Dict[str, Any] = {}       # the anchor, the enabling thread, on/off


def enable() -> None:
    """Turn the tracer on and anchor its clock."""
    global _on
    perf, wall = time.perf_counter_ns(), time.time_ns()
    _session.update(anchor=(perf, wall), thread=threading.get_native_id(),
                    on_ns=perf, off_ns=None)
    _on = True


def disable() -> None:
    """Turn the tracer off; what it recorded stays until `drain()`."""
    global _on
    _on = False
    if "anchor" in _session:
        _session["off_ns"] = time.perf_counter_ns()


def drain() -> Dict[str, Any]:
    """What was recorded since the last drain, and forget it:

        spans     [{"name", "start_ns", "end_ns", "thread", "id", "parent",
                    "ids"}] in the order they closed, stamps on time_ns's
                    clock; `parent` is the enclosing span's `id` (None at
                    the top of a thread)
        thread    the native id of the thread that called `enable()`
        on_ns, off_ns  when the tracer was turned on and off (time_ns's
                    clock; off_ns None while it is still on)
    """
    with _lock:
        rows, _records[:] = list(_records), []
    perf, wall = _session.get("anchor", (0, 0))
    to_wall = lambda t: None if t is None else t - perf + wall
    return {
        "spans": [{"name": name, "start_ns": to_wall(t0),
                   "end_ns": to_wall(t1), "thread": tid, "id": seq,
                   "parent": parent, "ids": ids}
                  for name, t0, t1, tid, seq, parent, ids in rows],
        "thread": _session.get("thread"),
        "on_ns": to_wall(_session.get("on_ns")),
        "off_ns": to_wall(_session.get("off_ns")),
    }


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------

def _stack() -> List["_Span"]:
    """The calling thread's open spans; its native id, read once, beside
    them (`_local.tid`)."""
    try:
        return _local.stack
    except AttributeError:
        _local.stack, _local.tid = [], threading.get_native_id()
        return _local.stack


class _Span:
    """One span; a context object, entered once."""
    __slots__ = ("name", "ids", "t0", "t1", "seq", "parent", "tid",
                 "recording")

    def __init__(self, name: str, ids: Dict[str, Any]):
        self.name, self.ids = name, ids
        self.t0 = self.t1 = None

    def __enter__(self) -> "_Span":
        self.recording = _on
        stack = _stack()
        parent = stack[-1] if stack else None
        if parent is not None and parent.ids:
            # a span without ids of its own shares its parent's dict
            self.ids = ({**parent.ids, **self.ids} if self.ids
                        else parent.ids)
        self.parent = parent.seq if parent is not None else None
        self.seq = next(_seq)
        if self.recording:
            self.tid = _local.tid
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.t1 = time.perf_counter_ns()
        _stack().pop()
        if self.recording:
            with _lock:
                _records.append((self.name, self.t0, self.t1, self.tid,
                                 self.seq, self.parent, self.ids))
        return False

    @property
    def seconds(self) -> float:
        """Its length in seconds, once closed."""
        return (self.t1 - self.t0) * 1e-9


class _Off:
    """What `span` returns while the tracer is off."""
    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


def span(name: str, **ids):
    """A span of `name` (module docstring); a shared no-op while off."""
    if not _on:
        return _OFF
    return _Span(name, ids)


def stage(name: str, **ids) -> _Span:
    """A span that always stamps: its `t0`, `t1` and `seconds` are read
    after it closes, traced or not."""
    return _Span(name, ids)
