"""The traced window: a ``torch.profiler`` trace of CPU and CUDA activity
over the window, read into device intervals, host intervals and the
window's bounds.

The window is the span ``portbench.window`` that the tracer opens on the
thread that starts it.  Device time is the union of the intervals of
kernels, copies and sets, clipped to the window (the arithmetic of
``chip_smoke.py::busy_share``).  An idle gap is named by the host
operation that overlaps it most (the shortest on a tie), so the
breakdown says what the host was doing while the card waited.
"""

from __future__ import annotations

import json
import os
import re

import numpy as np

WINDOW = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")
# gaps named one by one; the rest are summed under "other gaps"
NAMED_GAPS = 400


class Tracer:
    """Starts and stops the profiler around a window; ``trace`` holds the
    result once stopped."""

    def __init__(self, tmpdir: str):
        self.tmpdir = tmpdir
        self.trace = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=activities)
        self.prof.start()
        self.span = record_function(WINDOW)
        self.span.__enter__()

    def stop(self) -> None:
        import torch
        self.span.__exit__(None, None, None)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.stop()
        path = os.path.join(self.tmpdir, "trace.json")
        self.prof.export_chrome_trace(path)
        self.prof = None
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
        os.remove(path)
        self.trace = Trace(events)


class Trace:
    def __init__(self, events: list[dict]):
        spans = [e for e in events if e.get("name") == WINDOW
                 and e.get("ph") == "X"]
        if not spans:
            raise RuntimeError(f"the trace has no {WINDOW} span")
        self.t0 = float(spans[0]["ts"])
        self.t1 = self.t0 + float(spans[0]["dur"])
        dev = [e for e in events if e.get("cat") in DEVICE_CATS
               and e.get("ph") == "X"]
        self.dev_names = [e["name"] for e in dev]
        self.dev = np.array([(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                             for e in dev], np.float64).reshape(-1, 2)
        self.kernel = np.array([e.get("cat") == "kernel" for e in dev], bool)
        host = [e for e in events if e.get("cat") in HOST_CATS
                and e.get("ph") == "X" and e.get("name") != WINDOW]
        self.host_names = [e["name"] for e in host]
        self.host = np.array([(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                              for e in host], np.float64).reshape(-1, 2)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def _clipped(self, iv: np.ndarray) -> np.ndarray:
        return np.clip(iv, self.t0, self.t1)

    def busy_intervals(self) -> list[tuple[float, float]]:
        """The union of the device's intervals inside the window."""
        merged = []
        for a, b in sorted(map(tuple, self._clipped(self.dev))):
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def kernels(self, patterns: list[str]):
        """(indices of the kernels whose name matches one of ``patterns``,
        the share of each kernel's time inside the window)."""
        rx = re.compile("|".join(patterns))
        idx = np.array([i for i, n in enumerate(self.dev_names)
                        if self.kernel[i] and rx.search(n)], np.int64)
        if not len(idx):
            return idx, np.zeros(0)
        iv = self.dev[idx]
        inside = np.clip(self._clipped(iv)[:, 1] - self._clipped(iv)[:, 0],
                         0, None)
        share = inside / np.maximum(iv[:, 1] - iv[:, 0], 1e-9)
        keep = share > 0
        return idx[keep], share[keep]

    def durations_s(self, idx: np.ndarray) -> np.ndarray:
        return (self.dev[idx, 1] - self.dev[idx, 0]) / 1e6

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time in the window and the
        longest idle gaps, each named by the host operation beneath it."""
        clipped = self._clipped(self.dev)
        by_name: dict[str, float] = {}
        for name, (a, b) in zip(self.dev_names, clipped):
            if b > a:
                by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        busy = self.busy_intervals()
        edges = [self.t0] + [x for iv in busy for x in iv] + [self.t1]
        gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
        gaps.sort(key=lambda g: g[0] - g[1])
        named: dict[str, float] = {}
        hs, he = self.host[:, 0], self.host[:, 1]
        for a, b in gaps[:NAMED_GAPS]:
            overlap = np.minimum(he, b) - np.maximum(hs, a)
            if len(overlap) and overlap.max() > 0:
                best = overlap.max()
                cand = np.nonzero(overlap >= best)[0]
                i = cand[np.argmin(he[cand] - hs[cand])]
                name = self.host_names[i]
            else:
                name = "no host operation"
            named[name] = named.get(name, 0.0) + (b - a) / 1e6
        rest = sum(b - a for a, b in gaps[NAMED_GAPS:]) / 1e6
        if rest > 0:
            named["other gaps"] = rest
        gaps_out = sorted(named.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in gaps_out]}
