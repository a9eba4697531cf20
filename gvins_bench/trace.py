"""What the profiled sub-window of a traced run shows: the device's busy time
(the union of its operations' intervals), its kernels by name, and its idle
gaps by what the host was doing then (the harness's spans, which the
profiler records as annotations while it runs)."""

import bisect

import torch


def _union(intervals):
    """Merged [start, end) segments of sorted intervals."""
    out = []
    for s, e in intervals:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read(prof, labels):
    """A dict with the sub-window's device ``busy_s``, ``kernels`` (launches
    other than copies and fills), ``op_s`` (device seconds by operation name)
    and ``gap_s`` (idle seconds between device operations, by the innermost
    span in ``labels`` open on the host when the gap began, else "loop");
    None if the profiler saw no device operation."""
    cuda = torch.autograd.DeviceType.CUDA
    dev, spans = [], []
    for e in prof.profiler.kineto_results.events():
        name, s = e.name(), e.start_ns()
        if e.device_type() == cuda:
            if name not in labels:    # the profiler mirrors each annotation onto the device's timeline
                dev.append((s, s + e.duration_ns(), name))
        elif name in labels:
            spans.append((s, s + e.duration_ns(), name))
    if not dev:
        return None
    dev.sort()
    op_s, kernels = {}, 0
    for s, e, name in dev:
        op_s[name] = op_s.get(name, 0.0) + (e - s) / 1e9
        kernels += not name.lower().startswith(("memcpy", "memset"))
    busy = _union([(s, e) for s, e, _ in dev])
    spans.sort()
    starts = [s for s, _, _ in spans]
    gap_s = {}
    for (_, a), (b, _) in zip(busy[:-1], busy[1:]):
        label = "loop"
        for s, e, name in reversed(spans[:bisect.bisect_right(starts, a)]):
            if e > a:
                label = name
                break
        gap_s[label] = gap_s.get(label, 0.0) + (b - a) / 1e9
    return dict(busy_s=sum(e - s for s, e in busy) / 1e9, kernels=kernels, op_s=op_s, gap_s=gap_s)


def top(table, n=10):
    return [[name, seconds] for name, seconds in sorted(table.items(), key=lambda kv: -kv[1])[:n]]
