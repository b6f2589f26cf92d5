"""Kernel timing on one CUDA device.

`events_ms` times eager calls between CUDA events, so the host's launch
path (Python, ctypes, allocation, argument checks) is inside the number;
`graph_ms` captures the calls in one CUDA graph and replays it, so the
launches follow each other on the device with no host work between them
and the number is the device time a launch. Both need a CUDA device.
`device_record` names the device a measurement ran on.
"""
from __future__ import annotations

import subprocess
from typing import Any, Dict, Optional

import torch

GRAPH_REPS, GRAPH_REPLAYS = 20, 3


def events_ms(fn, reps: int = 20) -> float:
    """ms a call: CUDA events around `reps` eager calls (host included)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = GRAPH_REPS,
             replays: int = GRAPH_REPLAYS) -> float:
    """Device ms a call: `reps` calls captured in one CUDA graph, replayed
    `replays` times between CUDA events. Warmed up on a side stream first,
    as capture requires."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (reps * replays)
    del graph
    return ms


def in_turns(timer, a, b):
    """(mean ms of b, mean ms of a), timed a, b, b, a so that both see the
    same card state."""
    a1, b1, b2, a2 = timer(a), timer(b), timer(b), timer(a)
    return (b1 + b2) / 2, (a1 + a2) / 2


def card_line() -> Optional[str]:
    """`nvidia-smi --query-gpu=name,power.limit`'s first line (the card's
    name and power limit), or None where nvidia-smi cannot say."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.strip().splitlines()
    return lines[0] if lines else None


def device_record(device: torch.device) -> Dict[str, Any]:
    """The device a measurement ran on: on the card its platform 'gpu', its
    name, the card count and nvidia-smi's name and power limit; on the CPU
    platform 'cpu', whose numbers are no device metric."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    card = card_line()
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "card": card,
            "power_limit": card.split(",")[-1].strip() if card else None}


def require_device(name: str) -> torch.device:
    """The torch device `name`; RuntimeError where it is the card and none
    is present (a measurement never falls back to the CPU)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this tool measures the card; "
                           "pass --device cpu to run it on the CPU")
    return device
