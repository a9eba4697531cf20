#!/usr/bin/env python3
"""A traced run of one cell with the port's own tracer on
(``ic_gvins_tpu_torch/utils/timecost.py``): the keyframe episode split into
its stages, on one clock with the device trace.

    python3 gvins_bench/program_trace.py --workload <cell> --seed <n> --seconds <s> [--tracer 0|1]

It is ``run.py --trace 1`` with three additions, made around the harness's
own functions for the length of the run:

- the tracer is enabled as the window opens (``--tracer 0`` keeps it off, to
  measure what it costs), and the program's counters ``fetch.reads`` and
  ``lm.solve.steps`` are read there and where the profiler starts;
- the profiled sub-window's labels are the harness's and ``timecost.NAMES``,
  so that idle gaps go to the innermost program span, and so that no copy of
  a span on the device's rows (a user annotation's, which the tracer's
  function records do not leave) is read as a kernel and as busy time;
- ``unprofiled["program"]`` holds the tracer's records that start before the
  profiler does (a prefix of the records, so parent indices hold) and the
  counters' deltas over that part, which the six readers of the program's
  spans and counters read (``METRICS``).

The result line adds ``program``: the unprofiled part's wall time a frame,
its spans by name (count, total and self milliseconds), the host reads by
the span they sit in, how far each mirrored span's profiler duration lies
from the tracer's own, every idle gap label with its seconds, the profiled
sub-window's frames, episodes, LM iterations and kernels with its busy time
read both with and without the program's names among the labels (what the
mirrors would add as device work), and what one span costs the host off, on,
and on under the profiler (``span_cost_us``).
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# first: importing the harness starts its set-up clock and fixes the thread counts
from gvins_bench import run  # noqa: E402

import argparse  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402

METRICS = (("lm_steps_per_episode", "steps/episode"), ("lm_step_ms", "ms"), ("episode_host_ms", "ms"),
           ("marg_ms", "ms"), ("reads_per_frame", "reads/frame"), ("fetch_ms_per_frame", "ms/frame"))


def counters():
    from ic_gvins_tpu_torch.engine.host import fetch
    from ic_gvins_tpu_torch.solver import lm

    return dict(reads=fetch.reads, steps=lm.solve.steps)


def unprofiled_part(recs, cut_ns, c0, c1):
    """What the readers read: the records that start before ``cut_ns`` and
    the counters' deltas from ``c0`` to ``c1``."""
    n = next((i for i, r in enumerate(recs) if r[1] >= cut_ns), len(recs))
    return dict(records=recs[:n], reads=c1["reads"] - c0["reads"], steps=c1["steps"] - c0["steps"])


def stages(recs):
    """{name: [count, total ms, self ms]} and {span: [reads, ms]} of the
    host reads (``host.fetch``) by the span they sit in."""
    from ic_gvins_tpu_torch.utils import timecost

    table, reads = {}, {}
    for (name, s, e, parent, _), own in zip(recs, timecost.self_ns(recs)):
        if e is None:
            continue
        row = table.setdefault(name, [0, 0.0, 0.0])
        row[0] += 1
        row[1] += (e - s) / 1e6
        row[2] += own / 1e6
        if name == "host.fetch":
            row = reads.setdefault(recs[parent][0] if parent >= 0 else "", [0, 0.0])
            row[0] += 1
            row[1] += (e - s) / 1e6
    return table, reads


def mirror_gaps(prof, recs, start_ns):
    """How far each span's annotation in the profiled sub-window lies from
    the tracer's own duration (microseconds): the median, 90th percentile and
    largest gap, the spans and annotations counted, and the device-side
    mirrors the profiler made of them."""
    import torch

    from ic_gvins_tpu_torch.utils import timecost

    cuda = torch.autograd.DeviceType.CUDA
    host, device = {}, 0
    for e in prof.profiler.kineto_results.events():
        if e.name() in timecost.NAMES:
            if e.device_type() == cuda:
                device += 1
            else:
                host.setdefault(e.name(), []).append((e.start_ns(), e.duration_ns()))
    ours = {}
    for name, s, e, _, _ in recs:
        if s >= start_ns and e is not None:
            ours.setdefault(name, []).append(e - s)
    gaps = []
    for name, durations in ours.items():
        annotations = sorted(host.get(name, []))
        gaps += [abs(d - a) / 1e3 for d, (_, a) in zip(durations, annotations)]
    gaps.sort()
    return dict(median_us=statistics.median(gaps) if gaps else None,
                p90_us=gaps[int(0.9 * (len(gaps) - 1))] if gaps else None, max_us=gaps[-1] if gaps else None,
                spans=sum(map(len, ours.values())), annotations=sum(map(len, host.values())),
                device_mirrors=device)


def span_cost_us(n=20000):
    """Host microseconds of one ``span`` entered and left: the tracer off,
    on, and on while ``torch.profiler`` runs (CPU activity only, so that
    nothing waits on a device)."""
    import time

    import torch

    from ic_gvins_tpu_torch.utils import timecost

    was_on = timecost.enabled()

    def per_span(count):
        t0 = time.perf_counter_ns()
        for _ in range(count):
            with timecost.span("frame"):
                pass
        return (time.perf_counter_ns() - t0) / count / 1e3

    try:
        timecost.disable()
        off = per_span(n)
        timecost.enable()
        on = per_span(n)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            profiled = per_span(n // 10)
    finally:
        timecost.disable()
        if was_on:
            timecost.enable()
    return dict(off=off, on=on, on_profiled=profiled)


def run_traced(spec, seed, seconds, device, tracer=True, log=print):
    """One traced run of cell ``spec`` (``run.cell_spec``) with the port's
    tracer on (off with ``tracer=False``): ``run.run_cell``'s record with
    the six metrics of ``METRICS`` and ``program``."""
    from gvins_bench import trace as tr
    from gvins_bench.replay import Replay
    from ic_gvins_tpu_torch.utils import timecost

    state = {}
    start_profiler, context, labels = Replay._start_profiler, run.context, run.SPAN_LABELS

    def on_open(model):
        state["open"] = counters()
        if tracer:
            timecost.enable()

    def traced_start(rep):
        state["cut"] = counters()
        state["cut_episodes"] = rep.counters()["episodes"]
        start_profiler(rep)

    def traced_context(rep, setup_s, profile, least):
        ctx = context(rep, setup_s, profile, least)
        profiled = rep.prof is not None
        cut = rep.requests[rep.prof_req0] if profiled else rep.t_end
        recs = timecost.records()
        part = unprofiled_part(recs, round(cut * 1e9), state["open"], state["cut"] if profiled else counters())
        u = ctx["unprofiled"]
        u["program"] = part
        table, reads = stages(part["records"])
        state["program"] = dict(tracer=tracer, ms_per_frame=1e3 * u["wall_s"] / u["frames"], stages=table,
                                reads_in=reads,
                                mirrors=mirror_gaps(rep.prof, recs, round(rep.prof_start * 1e9)) if profiled else None,
                                idle_gaps=profile["gap_s"] if profile else None)
        if profile is not None:
            end, harness_only = counters(), tr.read(rep.prof, labels)
            state["program"]["profiled"] = dict(
                frames=rep.n_frames - rep.prof_req0, episodes=rep.counters1["episodes"] - state["cut_episodes"],
                steps=end["steps"] - state["cut"]["steps"], reads=end["reads"] - state["cut"]["reads"],
                kernels=profile["kernels"], busy_s=profile["busy_s"],
                kernels_harness_labels=harness_only["kernels"], busy_s_harness_labels=harness_only["busy_s"])
        return ctx

    Replay._start_profiler, run.context, run.SPAN_LABELS = traced_start, traced_context, labels + timecost.NAMES
    try:
        layer = spec["layer"] + [dict(name=name, unit=unit) for name, unit in METRICS]
        record = run.run_cell(dict(spec, layer=layer), seed, seconds, True, device, fault=on_open, log=log)
    finally:
        Replay._start_profiler, run.context, run.SPAN_LABELS = start_profiler, context, labels
        timecost.disable()
    checks = record.pop("checks")
    record["program"] = dict(state.get("program") or {}, span_cost_us=span_cost_us())
    record["checks"] = checks
    return record


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--tracer", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)

    import torch

    spec = run.cell_spec(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < spec["cell"]["chips"]:
        print("no result: no CUDA device", file=sys.stderr)
        return 2
    record = run_traced(spec, args.seed, args.seconds, "cuda", tracer=bool(args.tracer))
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
