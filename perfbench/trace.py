"""Reading the profiler's trace of a traced pass: device busy time, kernel
time by name, and what the host was doing while the device sat idle.

``torch.profiler`` records the device's activities (kernels, copies, sets)
and, where asked, the host's operations (with the benchmark's own
``bench.*`` spans). Device intervals are merged, so overlapping activities
count once toward ``busy_s``. Each gap between device activities is put to the
innermost host span that covers its middle.
"""
from __future__ import annotations

import bisect
from collections import defaultdict

__all__ = ["summarize"]

TOP = 10
SPAN_PREFIX = "bench."   # the clients' record_function spans


def _events(prof):
    res = prof.profiler.kineto_results
    out_dev, out_host = [], []
    for e in res.events():
        start = e.start_ns()
        end = start + e.duration_ns()
        on_device = str(e.device_type()).endswith("CUDA")
        if on_device and e.name().startswith(SPAN_PREFIX):
            continue   # a span's copy on the device's timeline: no work
        if on_device:
            out_dev.append((start, end, e.name()))
        else:
            out_host.append((start, end, e.name()))
    return out_dev, out_host


def _innermost(host, starts, t):
    """The shortest host span containing ``t`` among the 64 that start last
    before it; None if none does."""
    i = bisect.bisect_right(starts, t)
    best = None
    for j in range(i - 1, max(-1, i - 65), -1):
        s, e, name = host[j]
        if e >= t and (best is None or e - s < best[1] - best[0]):
            best = (s, e, name)
    return None if best is None else best[2]


def summarize(prof, window_s: float) -> dict:
    """``busy_s``, ``window_s``, seconds by device kernel name, the top
    device operations and the top idle gaps by host span."""
    dev, host = _events(prof)
    dev.sort()
    host.sort()
    by_name: dict[str, float] = defaultdict(float)
    busy_ns = 0
    gaps = []
    cur_s = cur_e = None
    for s, e, name in dev:
        by_name[name] += (e - s) * 1e-9
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s <= cur_e:
            cur_e = max(cur_e, e)
        else:
            busy_ns += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
    if cur_e is not None:
        busy_ns += cur_e - cur_s
    starts = [h[0] for h in host]
    idle_by: dict[str, float] = defaultdict(float)
    for a, b in gaps:
        name = _innermost(host, starts, (a + b) // 2) or "(no host span)"
        idle_by[name] += (b - a) * 1e-9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    idle = sorted(idle_by.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": busy_ns * 1e-9, "window_s": window_s,
            "kernels": dict(by_name),
            "device_ops": [[n[:160], s] for n, s in ops],
            "idle_gaps": [[n[:160], s] for n, s in idle],
            "device_events": len(dev)}
