"""The profiler over a traced window, read from its Chrome trace.

``Window`` runs ``torch.profiler`` (the device's activity and the CUDA
runtime calls) around the traced window and exports the trace to a
temporary file, which ``read_trace`` parses into device intervals and
host call intervals and then deletes.  From them: the device's busy time
(the union of kernel, memcpy and memset intervals), the kernels by name,
and the idle gaps, each named by the innermost runtime call the host was
in at its midpoint ("host idle": in none, running Python).
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")


@dataclass
class Trace:
    kernels: List[Tuple[str, float, float]] = field(default_factory=list)
    device: List[Tuple[float, float]] = field(default_factory=list)
    host: List[Tuple[float, float, str]] = field(default_factory=list)

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        busy, end = 0.0, float("-inf")
        for a, b in sorted(self.device):
            if b <= end:
                continue
            busy += b - max(a, end)
            end = b
        return busy / 1e6

    def gaps(self, t0: float, t1: float) -> List[Tuple[float, float]]:
        """Idle intervals of the device inside [t0, t1] (microseconds)."""
        out, end = [], t0
        for a, b in sorted(self.device):
            if a > end:
                out.append((end, min(a, t1)))
            end = max(end, b)
            if end >= t1:
                break
        if end < t1:
            out.append((end, t1))
        return [(a, b) for a, b in out if b > a]

    def host_at(self, t: float) -> str:
        """The innermost host operation running at time ``t``."""
        i = bisect.bisect_right(self.host, (t, float("inf"), ""))
        best, best_len = "host idle", float("inf")
        for a, b, name in self.host[max(0, i - 4000):i]:
            if a <= t <= b and b - a < best_len:
                best, best_len = name, b - a
        return best


class Window:
    """``with Window(enabled) as w:`` profiles the block when enabled;
    ``w.trace`` is the parsed trace after it."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.trace = None
        self._prof = None

    def __enter__(self):
        if self.enabled:
            import torch
            # device activity only where there is a device: recording
            # every host operation slows a host-bound loop by a third
            acts = ([torch.profiler.ProfilerActivity.CUDA]
                    if torch.cuda.is_available()
                    else [torch.profiler.ProfilerActivity.CPU])
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._prof is None:
            return False
        self._prof.__exit__(*exc)
        if exc[0] is None:
            fd, path = tempfile.mkstemp(suffix=".json")
            os.close(fd)
            try:
                self._prof.export_chrome_trace(path)
                self.trace = read_trace(path)
            finally:
                os.unlink(path)
        self._prof = None
        return False


def read_trace(path: str) -> Trace:
    with open(path) as f:
        doc = json.load(f)
    tr = Trace()
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        a = float(ev.get("ts", 0.0))
        b = a + float(ev.get("dur", 0.0))
        if cat in _DEVICE_CATS:
            tr.device.append((a, b))
            if cat == "kernel":
                tr.kernels.append((ev.get("name", "?"), a, b - a))
        elif cat in _HOST_CATS:
            tr.host.append((a, b, ev.get("name", "?")))
    tr.host.sort()
    return tr


def breakdown(tr: Trace, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time and the idle gaps (from
    the first device operation to the last) by what the host was doing,
    seconds each, at most ``top`` of each."""
    t0 = min(a for a, _ in tr.device)
    t1 = max(b for _, b in tr.device)
    by_name: Dict[str, float] = {}
    for name, _, dur in tr.kernels:
        by_name[name] = by_name.get(name, 0.0) + dur / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(tr.gaps(t0, t1), key=lambda g: g[0] - g[1])[:400]
    by_host: Dict[str, float] = {}
    for a, b in gaps:
        name = tr.host_at(0.5 * (a + b))
        by_host[name] = by_host.get(name, 0.0) + (b - a) / 1e6
    idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k[:160], v] for k, v in ops],
            "idle_gaps": [[k[:160], v] for k, v in idle]}
