"""A traced span of the window: ``torch.profiler`` over the CPU and the
card, reduced to what the per-layer metrics and the breakdown read."""
from __future__ import annotations

import bisect
import re
from collections import defaultdict

WINDOW_MARK = "portbench.window"


class Tracer:
    """Starts the profiler at the window's start and stops it at the first
    block end past ``seconds``; :meth:`reduce` turns its events into
    device intervals, busy time, the traced window and the breakdown."""

    def __init__(self, seconds):
        self.seconds = float(seconds)
        self.prof = None
        self.mark = None
        self.done = False

    def open(self):
        """Start the profiler; it takes a second or more to start, so this
        runs a block before the window does."""
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()

    def start(self):
        import torch
        self.mark = torch.profiler.record_function(WINDOW_MARK)
        self.mark.__enter__()

    def stop(self):
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.mark.__exit__(None, None, None)
        self.prof.stop()
        self.done = True

    def reduce(self):
        """``dict(window=(t0, t1) ns, device=[(name, t0, t1)], cpu=[(name,
        t0, t1)])`` from the profiler's raw events."""
        return split_events(_raw_events(self.prof))


def _raw_events(prof):
    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() if hasattr(e, "start_ns") else e.start_us() * 1e3
        dur = e.duration_ns() if hasattr(e, "duration_ns") \
            else e.duration_us() * 1e3
        out.append((e.name(), str(e.device_type()), float(start),
                    float(start + dur)))
    return out


def split_events(raw):
    """Raw ``(name, device_type, t0, t1)`` events into the window mark,
    the device's operations and the host's."""
    window, device, cpu = None, [], []
    for name, kind, t0, t1 in raw:
        if name == WINDOW_MARK:
            # the host's span; the card's copy of the annotation is
            # narrower, from its first operation to its last
            if not kind.endswith("CUDA"):
                window = (t0, t1)
        elif kind.endswith("CUDA"):
            device.append((name, t0, t1))
        else:
            cpu.append((name, t0, t1))
    return {"window": window, "device": device, "cpu": cpu}


def busy_intervals(device, window):
    """The union of the device's operations inside ``window``, sorted."""
    lo, hi = window
    spans = sorted((max(a, lo), min(b, hi)) for _, a, b in device
                   if b > lo and a < hi)
    merged = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def short_name(name):
    """A kernel's name without its namespaces, template arguments and
    parameters, with the functor it applies where the name holds one."""
    core = re.sub(r"^void\s+", "", name)
    functor = re.search(r"(\w+Functor|\w+_kernel_impl|\w+_kernel_cuda)",
                        core)
    base = re.split(r"[<(]", core, maxsplit=1)[0].split("::")[-1].strip()
    if functor and functor.group(1) != base:
        return f"{base}:{functor.group(1)}"
    return base or name[:64]


def breakdown(events, top=10):
    """Busy seconds, the traced window's seconds, the device operations
    that took most time and the longest idle gaps by the innermost host
    operation running at each gap's middle ("python" where none ran)."""
    window = events["window"]
    merged = busy_intervals(events["device"], window)
    busy_ns = sum(b - a for a, b in merged)
    by_op = defaultdict(float)
    lo, hi = window
    for name, a, b in events["device"]:
        if b > lo and a < hi:
            by_op[short_name(name)] += (min(b, hi) - max(a, lo)) * 1e-9
    cpu = sorted(events["cpu"], key=lambda e: e[1])
    starts = [e[1] for e in cpu]
    gaps = defaultdict(float)
    edges = [lo] + [x for span in merged for x in span] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        owner = "python"
        i = bisect.bisect_right(starts, mid)
        for name, s, e in reversed(cpu[max(0, i - 256):i]):
            if e >= mid:
                owner = name
                break
        gaps[owner] += (b - a) * 1e-9
    ranked = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return {"busy_s": busy_ns * 1e-9, "window_s": (hi - lo) * 1e-9,
            "device_ops": [[k, v] for k, v in ranked],
            "idle_gaps": [[k, v] for k, v in idle]}


def device_seconds(events, match):
    """Device seconds and call count of the operations inside the window
    whose names contain ``match``."""
    lo, hi = events["window"]
    total, count = 0.0, 0
    for name, a, b in events["device"]:
        if match in name and b > lo and a < hi:
            total += (b - a) * 1e-9
            count += 1
    return total, count
