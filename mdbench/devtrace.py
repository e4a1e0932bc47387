"""Reduce a torch.profiler trace of the window to the records the
per-layer readers take: per card, the union of device-op intervals (busy
seconds), device seconds by op name and memcpy kind; the host's runtime
launch calls; the longest idle gaps by what the host was doing."""

from __future__ import annotations

import bisect
import collections

import torch

LAUNCH_PREFIXES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch")
TOP = 10
#: host events looked back over to name an idle gap
GAP_LOOKBACK = 2000


def profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _union(intervals):
    """Merged [start, end) intervals (us), sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def summarize(prof) -> dict:
    cuda = torch.autograd.DeviceType.CUDA
    dev_ops = collections.defaultdict(list)
    host = []
    launches = 0
    # the profiler's raw events (no tree of function events is built)
    for e in prof.profiler.kineto_results.events():
        t0, t1, name = e.start_ns() * 1e-3, e.end_ns() * 1e-3, e.name()
        if e.device_type() == cuda:
            dev_ops[e.device_index()].append((t0, t1, name))
        else:
            host.append((t0, t1, name))
            if name.startswith(LAUNCH_PREFIXES):
                launches += 1
    host.sort()
    starts = [h[0] for h in host]
    cards = {}
    gaps = collections.Counter()
    for d, ops in sorted(dev_ops.items()):
        merged = _union([(a, b) for a, b, _ in ops])
        by_name = collections.Counter()
        memcpy = collections.Counter()
        for a, b, name in ops:
            by_name[name] += (b - a) * 1e-6
            if name.startswith("Memcpy"):
                memcpy[name] += (b - a) * 1e-6
        cards[d] = dict(busy_s=sum(b - a for a, b in merged) * 1e-6,
                        ops=dict(by_name), memcpy=dict(memcpy))
        for (_, g0), (g1, _) in zip(merged, merged[1:]):
            gaps[_host_at(host, starts, g0)] += (g1 - g0) * 1e-6
    return dict(cards=cards, launch_calls=launches,
                idle_gaps=gaps.most_common(TOP))


def _host_at(host, starts, t):
    """The innermost host event running at t (the latest started that
    has not ended), or 'host idle'."""
    i = bisect.bisect_right(starts, t)
    best = None
    for k in range(i - 1, max(-1, i - 1 - GAP_LOOKBACK), -1):
        a, b, name = host[k]
        if b >= t and (best is None or a > best[0]):
            best = (a, name)
            break
    return best[1] if best else "host idle"


def top_ops(summary: dict) -> list:
    total = collections.Counter()
    for c in summary["cards"].values():
        total.update(c["ops"])
    return [[name[:120], s] for name, s in total.most_common(TOP)]
