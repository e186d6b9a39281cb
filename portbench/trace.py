"""The traced window: one ``torch.profiler`` session over the window, read
once into plain arrays.

Device time is the union of the intervals of every operation the card ran
(kernels, copies, sets) inside the window, so overlapping kernels are not
counted twice.  Each stretch of the window in which the card ran nothing is
labelled by what the host's window thread was doing at its midpoint: the
innermost profiler event there, behind the innermost ``portbench.*`` span
that holds it.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict

WINDOW_SPAN = "portbench.window"
SHORT_GAP_NS = 20_000       # gaps below this are dispatch latency, pooled
SCAN = 2000                 # host events searched back for the innermost
TOP = 10


class Trace:
    def __init__(self, events, window_s: float):
        self.window_s = window_s
        self.kernels = []       # (start_ns, end_ns, name) on the device
        cpu = []                # (start_ns, end_ns, name, thread)
        span = None
        for ev in events:
            start, dur = ev["start"], ev["dur"]
            if ev["device"]:
                if ev["annotation"] or ev["name"].startswith("portbench."):
                    continue
                self.kernels.append((start, start + dur, ev["name"]))
            else:
                cpu.append((start, start + dur, ev["name"], ev["thread"]))
                if ev["name"] == WINDOW_SPAN:
                    span = (start, start + dur, ev["thread"])
        if span is None:
            raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span")
        self.start, self.end, thread = span
        self.kernels = [k for k in self.kernels
                        if k[1] > self.start and k[0] < self.end]
        self.kernels.sort()
        main = sorted(c for c in cpu if c[3] == thread)
        self.cpu_start = [c[0] for c in main]
        self.cpu = main
        self.spans = [c for c in main if c[2].startswith("portbench.")
                      and c[2] != WINDOW_SPAN]

    def kernel_seconds(self, *names) -> float:
        """Summed device time of the kernels whose name holds any of
        ``names``."""
        return sum(e - s for s, e, n in self.kernels
                   if any(x in n for x in names)) / 1e9

    def kernel_count(self, *names) -> int:
        return sum(any(x in n for x in names) for _, _, n in self.kernels)

    def busy_intervals(self):
        out = []
        for s, e, _ in self.kernels:
            s, e = max(s, self.start), min(e, self.end)
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def gaps(self):
        gaps, at = [], self.start
        for s, e in self.busy_intervals():
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        if self.end > at:
            gaps.append((at, self.end))
        return gaps

    def host_label(self, t_ns: int) -> str:
        """What the window's thread was doing at ``t_ns``: the innermost
        ``portbench.*`` span that holds it, then the innermost profiler
        event that holds it ("Python" where none does)."""
        inner = None
        j = bisect.bisect_right(self.cpu_start, t_ns) - 1
        for k in range(j, max(j - SCAN, -1), -1):
            s, e, name, _ = self.cpu[k]
            if e >= t_ns and not name.startswith("portbench."):
                inner = name
                break
        span = None
        for s, e, name, _ in self.spans:
            if s <= t_ns <= e:
                span = name
        return f"{span or 'window'}: {inner or 'Python'}"

    def breakdown(self) -> dict:
        ops = defaultdict(int)
        for s, e, n in self.kernels:
            ops[n[:160]] += e - s
        idle = defaultdict(int)
        for s, e in self.gaps():
            label = ("gaps under 20 us" if e - s < SHORT_GAP_NS
                     else self.host_label((s + e) // 2)[:160])
            idle[label] += e - s
        top = sorted(ops.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[n, v / 1e9] for n, v in top],
                "idle_gaps": [[n, v / 1e9] for n, v in gaps]}


class Profiled:
    """``with Profiled(on) as p:`` around the window; ``p.trace`` after it
    (None when ``on`` is false)."""

    def __init__(self, on: bool):
        self.on, self.trace = on, None

    def __enter__(self):
        if not self.on:
            return self
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._span = record_function(WINDOW_SPAN)
        self._span.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if not self.on:
            return False
        import torch

        torch.cuda.synchronize()
        window_s = time.perf_counter() - self._t0
        self._span.__exit__(*exc)
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.trace = Trace(raw_events(self._prof), window_s)
        return False


def raw_events(prof):
    """Each profiler event as a small dict, from the raw results where this
    torch has them (building the function-event tree for a million events
    takes minutes)."""
    from torch.autograd import DeviceType

    results = getattr(prof.profiler, "kineto_results", None)
    if results is not None:
        for ev in results.events():
            yield {"name": ev.name(), "start": ev.start_ns(),
                   "dur": ev.duration_ns(),
                   "device": ev.device_type() == DeviceType.CUDA,
                   "annotation": ev.is_user_annotation(),
                   "thread": ev.start_thread_id()}
        return
    for ev in prof.events():
        yield {"name": ev.name, "start": int(ev.time_range.start * 1000),
               "dur": int(ev.time_range.elapsed_us() * 1000),
               "device": ev.device_type == DeviceType.CUDA,
               "annotation": ev.is_user_annotation,
               "thread": ev.thread}
