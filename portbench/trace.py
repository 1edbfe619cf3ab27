"""The benchmark's own spans around its calls into the program, and the
device timeline of a traced window.

``Spans`` times each call on the host clock and, in a traced run, wraps it
in a ``torch.profiler.record_function`` range named ``portbench.<span>``.
``Timeline.read`` takes the raw events of a ``torch.profiler`` run: the
window (the ``portbench.window`` range), the device's operations clipped to
it (kernels, copies, fills; not the mirrored user ranges) and the host's
``portbench.*`` ranges. The busy time is the union of the device intervals,
so operations that overlap count once.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import defaultdict

import torch

PREFIX = "portbench."
WINDOW = PREFIX + "window"


class Spans:
    """Host-clock durations (seconds) of the benchmark's calls, by name;
    ``sync`` ends a span with a device synchronise."""

    def __init__(self, trace: bool, device: torch.device):
        self.trace, self.device = trace, device
        self.times: dict[str, list[float]] = defaultdict(list)

    @contextlib.contextmanager
    def __call__(self, name: str, sync: bool = False):
        rf = torch.profiler.record_function(PREFIX + name) if self.trace else None
        if rf is not None:
            rf.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.times[name].append(time.perf_counter() - t0)
            if rf is not None:
                rf.__exit__(None, None, None)


@dataclasses.dataclass
class Timeline:
    window: tuple[int, int]  # ns
    device: list[tuple[str, int, int]]  # (name, start, end) ns, in the window
    host: list[tuple[str, int, int]]  # the benchmark's spans, ns

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    @classmethod
    def read(cls, prof) -> "Timeline":
        dev_type = torch.autograd.DeviceType
        window, device, host = None, [], []
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            start = int(e.start_ns())
            end = start + int(e.duration_ns())
            if name.startswith(PREFIX):
                if e.device_type() == dev_type.CPU:
                    if name == WINDOW:
                        window = (start, end)
                    else:
                        host.append((name[len(PREFIX):], start, end))
                continue
            if e.device_type() == dev_type.CUDA and not e.is_user_annotation():
                device.append((name, start, end))
        if window is None:
            raise RuntimeError("the trace holds no portbench.window range")
        lo, hi = window
        device = [(n, max(s, lo), min(t, hi)) for n, s, t in device if t > lo and s < hi]
        return cls(window, sorted(device, key=lambda r: r[1]), sorted(host, key=lambda r: r[1]))

    def busy_intervals(self) -> list[tuple[int, int]]:
        """The union of the device's intervals, in order."""
        out: list[list[int]] = []
        for _, s, t in sorted(self.device, key=lambda r: r[1]):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], t)
            else:
                out.append([s, t])
        return [(s, t) for s, t in out]

    def busy_s(self) -> float:
        return sum(t - s for s, t in self.busy_intervals()) / 1e9

    def gaps(self) -> list[tuple[int, int]]:
        """The window's idle intervals, between and around the busy ones."""
        out, at = [], self.window[0]
        for s, t in self.busy_intervals():
            if s > at:
                out.append((at, s))
            at = max(at, t)
        if self.window[1] > at:
            out.append((at, self.window[1]))
        return out

    def host_span_at(self, t_ns: int) -> str:
        """The innermost benchmark span the host was in at ``t_ns``."""
        best = None
        for name, s, t in self.host:
            if s <= t_ns < t and (best is None or s >= best[1]):
                best = (name, s)
        return best[0] if best else "outside_spans"

    def kernel_time_s(self, match) -> float:
        """Device seconds of the operations whose name ``match`` accepts."""
        return sum(t - s for n, s, t in self.device if match(n)) / 1e9

    def breakdown(self, top: int = 10) -> dict:
        by_name: dict[str, int] = defaultdict(int)
        for n, s, t in self.device:
            by_name[n[:160]] += t - s
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n, v / 1e9] for n, v in ops],
                "idle_gaps": [[self.host_span_at(s), (t - s) / 1e9] for s, t in gaps]}


@dataclasses.dataclass
class Run:
    """What a cell's window did, for the per-layer readers
    (``portbench/metrics/*.py``)."""

    kind: str
    config: dict
    mix: dict
    units: int  # steps or requests in the window
    lens: list  # each unit's trial lengths (numpy [B])
    spans: dict[str, list[float]]
    timeline: Timeline | None = None
