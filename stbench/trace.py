"""A bounded span of the device's activities, by torch.profiler with CUDA
activities only (the host's ops are not recorded: that costs a minute a
batch), and the kernel launches the program counted in it, by shape.

The span is opened and closed with the card waited for, so every device
activity of the span lies inside it and `window_s`, the host clock between
the two, is the span's length. The trace is exported and read after the
measured window (`finish`).
"""
from __future__ import annotations

import json
import time
from collections import Counter
from pathlib import Path
from typing import Dict, Optional

import torch

from stbench import yardstick


class Span:
    def __init__(self, device: torch.device, tmp: Path):
        self.device, self.tmp = device, Path(tmp)
        self.prof = None
        self.t0 = self.t1 = None
        self.launches: Counter = Counter()
        self.counting = False
        self.extra: Dict = {}

    def warm(self) -> None:
        """Open and close the profiler once over one small operation, so
        that its first start (CUPTI's set-up, seconds) falls in set-up."""
        if self.cuda:
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]):
                torch.ones(1, device=self.device).add_(1)
                torch.cuda.synchronize(self.device)

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    def start(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)
            self.prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            self.prof.start()
        self.counting = True
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)
        self.t1 = time.perf_counter()
        self.counting = False
        if self.prof is not None:
            self.prof.stop()

    @property
    def closed(self) -> bool:
        return self.t1 is not None

    def count(self, kernel: str, lead, n: int, k: int, h: int) -> None:
        """One launch of a program's kernel wrapper at its shape (lanes,
        points, centers, hidden), while the span is open."""
        if self.counting:
            m = int(lead[0]) if lead else 1
            self.launches[(kernel, m, int(n), int(k), int(h))] += 1

    def finish(self) -> Optional[Dict]:
        """The span's observation once closed: its device events, length
        and launches (and what the driver added), or None where it never
        closed."""
        if not self.closed:
            return None
        events = []
        if self.prof is not None:
            path = self.tmp / "span_trace.json"
            self.prof.export_chrome_trace(str(path))
            with open(path, "r", encoding="utf-8") as f:
                events = yardstick.device_events(json.load(f))
            path.unlink()
            self.prof = None
        return dict(self.extra, events=events, window_s=self.t1 - self.t0,
                    launches=dict(self.launches))
