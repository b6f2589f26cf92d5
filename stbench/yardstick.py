"""The benchmark's yardstick: peak rates, the work of a kernel or a model
row counted from shapes, and the interval arithmetic of a device trace.

Frozen here so that no later change to the program moves its own bar.

Peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet, dense):
a float32-accurate product runs as three TF32 products on the tensor cores
(495 / 3 TFLOP/s), elementwise float32 work outside them at 67 TFLOP/s, HBM at
3.35 TB/s. The kernel bound is a copy of `chip_smoke.py::bound_ms` (the
port's kernel table): each input byte read once and each output byte written
once, against the products at the 3xTF32 rate and the per-pair basis chain
(PHI_OPS float32 operations a (point, center) pair forward, DPHI_OPS for the
derivative chain) in float32; a launch with a lane axis of M lanes is M
times one lane's work. The interval arithmetic is that of
`st_dadk_tpu_torch/trace_steady_state.py` (union of device activities,
idle as its complement in the window), on chrome-trace events.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

TF32X3_FLOPS = 495e12 / 3
F32_FLOPS = 67e12
HBM_BYTES_S = 3.35e12
PHI_OPS, DPHI_OPS = 20, 25
F = 4  # bytes of a float32


def fused_kernel_work(kernel: str, m: int, n: int, k: int, h: int
                      ) -> Tuple[float, float, float]:
    """(product FLOPs, per-pair float32 operations, bytes) of one launch of
    a fused first-layer kernel ('fwd', 'bwd_w', 'bwd_centers') over m lanes
    of n points, k centers and h hidden columns."""
    read = F * (2 * n + 3 * k)                 # coords, centers, inv_bw
    pairs = n * k
    moved = read + {"fwd": F * k * h + F * n * h,
                    "bwd_w": F * n * h + F * k * h,
                    "bwd_centers": F * k * h + F * n * h + 3 * F * k}[kernel]
    chain = (PHI_OPS if kernel in ("fwd", "bwd_w") else DPHI_OPS) * pairs
    return m * 2.0 * n * k * h, m * float(chain), m * float(moved)


def least_seconds(products: float, chain: float, moved: float) -> float:
    """The least time the card could take for that work: the larger of the
    products at the 3xTF32 rate, the chain in float32 and the bytes at the
    HBM rate."""
    return max(products / TF32X3_FLOPS, chain / F32_FLOPS, moved / HBM_BYTES_S)


def fused_least_seconds(kernel: str, m: int, n: int, k: int, h: int) -> float:
    return least_seconds(*fused_kernel_work(kernel, m, n, k, h))


def forward_row_flops(k_spatial: int, k_temporal: int,
                      hidden: Sequence[int], out_dim: int) -> float:
    """Product FLOPs of one point's forward: the first layer over
    [phi | psi], each hidden layer, the head (2 a multiply-add)."""
    widths = [k_spatial + k_temporal, *hidden, out_dim]
    return 2.0 * sum(a * b for a, b in zip(widths[:-1], widths[1:]))


def train_row_flops(k_spatial: int, k_temporal: int, hidden: Sequence[int],
                    out_dim: int, learnable: bool) -> float:
    """Product FLOPs of one training row: the forward, every layer's weight
    gradient (the forward's again), the input gradient of every layer but
    the first (its inputs are data), and for a learnable basis the
    g . w^T product of the centers' gradient (k_spatial x first width)."""
    fwd = forward_row_flops(k_spatial, k_temporal, hidden, out_dim)
    first = 2.0 * (k_spatial + k_temporal) * hidden[0]
    centers = 2.0 * k_spatial * hidden[0] if learnable else 0.0
    return fwd + fwd + (fwd - first) + centers


def share_pct(part: float, whole: float):
    """part / whole in percent, or None where there is nothing to divide
    (a reader that finds nothing reports nothing)."""
    if whole is None or part is None or whole <= 0 or part <= 0:
        return None
    return 100.0 * part / whole


# ---------------------------------------------------------------------------
# Device-trace intervals
# ---------------------------------------------------------------------------

Interval = Tuple[float, float]


def union(intervals: Iterable[Interval]) -> List[Interval]:
    """The union of [start, end) intervals as sorted disjoint intervals."""
    out: List[Interval] = []
    for s, e in sorted(i for i in intervals if i[1] > i[0]):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def covered(intervals: Iterable[Interval]) -> float:
    """Length of the union."""
    return sum(e - s for s, e in union(intervals))


def gaps(intervals: Iterable[Interval], lo: float, hi: float
         ) -> List[Tuple[float, float, int]]:
    """The idle gaps of [lo, hi) outside the union, as (start, end, index of
    the busy interval that follows, or -1 at the end)."""
    u = [(max(s, lo), min(e, hi)) for s, e in union(intervals)
         if e > lo and s < hi]
    out, t = [], lo
    for i, (s, e) in enumerate(u):
        if s > t:
            out.append((t, s, i))
        t = max(t, e)
    if hi > t:
        out.append((t, hi, -1))
    return out


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_events(trace: Dict) -> List[Dict]:
    """The device activities of a chrome trace (torch.profiler's export):
    {'name', 'cat', 'start', 'end'} in seconds on the trace's clock."""
    out = []
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") == "X" and ev.get("cat") in DEVICE_CATS:
            s = float(ev["ts"]) * 1e-6
            out.append({"name": str(ev.get("name", "")), "cat": ev["cat"],
                        "start": s, "end": s + float(ev.get("dur", 0)) * 1e-6})
    return out


def busy_seconds(events: Sequence[Dict]) -> float:
    return covered((e["start"], e["end"]) for e in events)


def seconds_by_name(events: Sequence[Dict]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for e in events:
        out[e["name"]] = out.get(e["name"], 0.0) + (e["end"] - e["start"])
    return out


def breakdown(events: Sequence[Dict], top: int = 10) -> Dict[str, list]:
    """The device operations that took most time, and the longest idle
    gaps, each named by the operations on either side of it."""
    ops = sorted(seconds_by_name(events).items(), key=lambda kv: -kv[1])
    if not events:
        return {"device_ops": [], "idle_gaps": []}
    lo = min(e["start"] for e in events)
    hi = max(e["end"] for e in events)
    order = sorted(events, key=lambda e: e["start"])
    ends = union((e["start"], e["end"]) for e in order)
    # the operation that starts each busy interval and the one that ends it
    first_of, last_of = [], []
    j = 0
    for s, e in ends:
        first_of.append(order[j]["name"])
        last = order[j]
        while j < len(order) and order[j]["start"] < e:
            if order[j]["end"] >= last["end"]:
                last = order[j]
            j += 1
        last_of.append(last["name"])
    idle = []
    for s, e, nxt in gaps([(a, b) for a, b in ends], lo, hi):
        before = (last_of[-1] if nxt < 0 else
                  last_of[nxt - 1] if nxt > 0 else "start")
        after = first_of[nxt] if nxt >= 0 else "end"
        idle.append((f"after {short(before)} before {short(after)}", e - s))
    idle.sort(key=lambda kv: -kv[1])
    return {"device_ops": [[short(n), s] for n, s in ops[:top]],
            "idle_gaps": [[n, s] for n, s in idle[:top]]}


def short(name: str, width: int = 90) -> str:
    """A kernel's name without its argument list, cut to `width`."""
    name = name.replace("(anonymous namespace)::", "").split("(", 1)[0]
    return name[5:width + 5] if name.startswith("void ") else name[:width]


# ---------------------------------------------------------------------------
# Per-layer readings of a traced span (the metric readers' arithmetic)
# ---------------------------------------------------------------------------

# the fused first layer's kernels in the device trace, by the wrapper that
# launches them: the forward is the kernel template of four parameters; a d
# centers call is its kernel and its ordered slab sum
FUSED_KERNELS = {
    "fwd": ("fused_first_layer_fwd", (r"fwd_kernel<\d+, ?\d+, ?\d+, ?\d+>",)),
    "bwd_centers": ("fused_first_layer_bwd_centers",
                    (r"(?<!_)bwd_centers_kernel\b", r"centers_sum_kernel")),
}


def kernel_seconds(events: Sequence[Dict], patterns: Sequence[str]) -> float:
    import re
    rx = [re.compile(p) for p in patterns]
    return sum(e["end"] - e["start"] for e in events if e["cat"] == "kernel"
               and any(r.search(e["name"]) for r in rx))


def fused_roofline_pct(span, kernel: str):
    """A fused kernel's share of its roofline over the span: the least time
    of its counted launches at their shapes over its device time."""
    if not span or not span.get("events"):
        return None
    wrapper, patterns = FUSED_KERNELS[kernel]
    least = sum(count * fused_least_seconds(kernel, m, n, k, h)
                for (name, m, n, k, h), count in span["launches"].items()
                if name == wrapper)
    return share_pct(least, kernel_seconds(span["events"], patterns))


def idle_pct(span):
    if not span or not span.get("events"):
        return None
    return 100.0 * (1.0 - busy_seconds(span["events"]) / span["window_s"])


def copy_pct(span):
    if not span or not span.get("events"):
        return None
    copies = covered((e["start"], e["end"]) for e in span["events"]
                     if e["cat"] == "gpu_memcpy")
    return share_pct(copies, span["window_s"])


def span_flops(span, model: Dict) -> float:
    """Product FLOPs of the span's work: a training span's steps (lanes x
    batch rows a step) and validations (lanes x validation rows an epoch),
    or a predict span's requests x points."""
    fwd = forward_row_flops(model["k_spatial"], model["k_temporal"],
                            model["hidden"], model["out_dim"])
    if "requests" in span:
        return span["requests"] * span["points"] * fwd
    train = train_row_flops(model["k_spatial"], model["k_temporal"],
                            model["hidden"], model["out_dim"],
                            model["learnable"])
    lanes, epochs = span["M"], span["epochs"]
    return epochs * lanes * (span["B"] * span["bs"] * train
                             + span["val_cap"] * fwd)


def mfu_pct(span, model: Dict):
    """The span's product FLOPs over the span at the float32-accurate
    product peak."""
    if not span or not span.get("events"):
        return None
    return share_pct(span_flops(span, model) / TF32X3_FLOPS, span["window_s"])
