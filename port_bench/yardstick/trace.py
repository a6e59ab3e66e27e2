"""What a ``torch.profiler`` Chrome trace of the server says: the device's
busy time, its operations by name, and its idle gaps by what the host was
doing.

Device operations are the events of category ``kernel``, ``gpu_memcpy``
and ``gpu_memset`` (CUPTI records each kernel of a CUDA graph replay on its
own). The host processes the trace holds are its ``process_labels``
metadata rows labelled ``CPU`` (the profiled process's pid). The traced
window runs from the trace's first event to its last.
An idle gap ends where a device operation starts; the runtime call that
launched it (by the trace's ``correlation`` id) names the gap: if the host
issued that call inside the gap, the device waited for the host
(``host_issuing_<call>``); if the call was issued before the gap began,
the device waited on something else after it (``device_waiting_after_
<call>``), such as a stream dependency.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
RUNTIME_CATS = {"cuda_runtime", "cuda_driver"}


@dataclass
class Trace:
    window_us: float = 0.0
    busy_us: float = 0.0
    gaps_us: dict[str, float] = field(default_factory=dict)  # idle time by cause
    durations_us: dict[str, list[float]] = field(default_factory=dict)  # by op name
    host_pids: set = field(default_factory=set)  # the profiled host process(es)

    @property
    def ops_us(self) -> dict[str, float]:
        """Device time by operation name."""
        return {name: sum(ds) for name, ds in self.durations_us.items()}

    def kernel_durations_us(self, pattern: str) -> list[float]:
        """Every device operation's duration whose name matches ``pattern``."""
        rx = re.compile(pattern)
        return [d for name, ds in self.durations_us.items() if rx.search(name) for d in ds]


def _label(name: str) -> str:
    return re.sub(r"\W+", "_", name).strip("_")[:64] or "unnamed"


def read_trace(path) -> Trace:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    t = Trace(host_pids={e.get("pid") for e in events
                         if e.get("ph") == "M" and e.get("name") == "process_labels"
                         and (e.get("args") or {}).get("labels") == "CPU"})
    if not spans:
        return t
    start = min(float(e["ts"]) for e in spans)
    end = max(float(e["ts"]) + float(e["dur"]) for e in spans)
    t.window_us = end - start
    launch = {}
    dev = []
    for e in spans:
        corr = (e.get("args") or {}).get("correlation")
        if e.get("cat") in RUNTIME_CATS and corr is not None:
            launch[corr] = (float(e["ts"]), e["name"])
        elif e.get("cat") in DEVICE_CATS:
            a, d = float(e["ts"]), float(e["dur"])
            dev.append((a, a + d, e["name"], corr))
            t.durations_us.setdefault(e["name"], []).append(d)
    dev.sort()
    busy_end = start
    for a, b, _, corr in dev:
        if a > busy_end:  # an idle gap [busy_end, a], ended by this op
            issued = launch.get(corr)
            if issued is None:
                cause = "unattributed"
            elif issued[0] >= busy_end:
                cause = f"host_issuing_{_label(issued[1])}"
            else:
                cause = f"device_waiting_after_{_label(issued[1])}"
            t.gaps_us[cause] = t.gaps_us.get(cause, 0.0) + (a - busy_end)
            t.busy_us += b - a
            busy_end = b
        elif b > busy_end:
            t.busy_us += b - busy_end
            busy_end = b
    if end > busy_end:
        t.gaps_us["after_last_device_op"] = end - busy_end
    return t


def top(d: dict[str, float], n: int = 10) -> list[list]:
    """The ``n`` largest entries as [[label, seconds], ...]."""
    return [[_label(k), v / 1e6] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
