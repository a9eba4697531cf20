#!/usr/bin/env python3
"""The benchmark of the PyTorch and CUDA port: one cell of BENCHMARK.json.

    python3 gvins_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds the port (``ic_gvins_tpu_torch``)
on a machine with a CUDA device; without one it exits with code 2 and prints
no result. The cell names a configuration (``configs/<config>.yaml``, the
gvins.yaml the port reads with its own ``load_config``, and
``configs/<config>.json``, the deployment's world) and a traffic mix
(``traffic/<traffic>.json``); its limits are ``limits/<cell>.json``, and
every metric is read by ``metrics/<metric>.py``. Set-up builds the seeded
world and renders its frames, then replays the log through
``GvinsModel.run`` as ``scripts/run_gvins_torch.py`` does, outputs into a
directory under ``TMPDIR``, through the initializations; the window then
measures ``--seconds`` of the closed loop (``replay.py``). After it the
outputs the window produced are held against the plain reference
(``check.py``).

Standard output ends with one JSON line: ``correct``, ``attempted`` (frames
handed over in the window), ``failed`` (frames whose processing raised),
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each compared number beside its limit; standard error ends with
the same numbers. ``--control 1`` also prints the control's readings (the
reference one precision lower in the program's place) and is not part of a
measured run.
"""

import os
import time

T_PROCESS = time.perf_counter()
# one process with one host thread: the replay's host work is small ops, and
# thread pools only add jitter between runs
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "1"

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "ic_gvins_tpu")
SPAN_LABELS = ("episode", "ins", "track")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def load_json(path):
    with open(path) as f:
        return json.load(f)


def cell_spec(workload):
    """Everything a run of cell ``workload`` reads, found by the names in
    BENCHMARK.json: its entry, the configuration (the gvins.yaml path and the
    world's JSON), the traffic mix, the limits, and the end-to-end and
    per-layer metric entries it reports."""
    bench = load_json(ROOT / "BENCHMARK.json")
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    own = lambda m: workload in m.get("workloads", [workload])  # noqa: E731
    e2e = [m for m in bench["end_to_end"] if own(m)]
    reported = {m["name"] for m in e2e}
    return dict(cell=cell, yaml=HERE / "configs" / f"{cell['config']}.yaml",
                cfg=load_json(HERE / "configs" / f"{cell['config']}.json"),
                traffic=load_json(HERE / "traffic" / f"{cell['traffic']}.json"),
                limits=load_json(HERE / "limits" / f"{workload}.json"),
                e2e=e2e, layer=[m for m in bench["per_layer"] if own(m) and m["moves"] in reported])


def reader(name):
    spec = importlib.util.spec_from_file_location(f"gvins_bench_metric_{name}", HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def card(torch):
    """The card's name, power limit and clocks (nvidia-smi), or what failed."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                               "--format=csv,noheader"], capture_output=True, text=True, timeout=20,
                              check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError) as e:
        return f"{torch.cuda.get_device_name(0)}; nvidia-smi failed: {e}"


def context(rep, setup_s, profile, least):
    """What the metric readers read: the window's host clock, the program's
    counters, the spans of the unprofiled part, the profiled sub-window."""
    ctx = dict(frames=rep.n_frames, wall_s=rep.wall_s, sim_s=rep.sim_s, intervals_ms=rep.frame_intervals_ms(),
               setup_s=setup_s, counters=(rep.counters0, rep.counters1), profile=None)
    if rep.trace:
        cut = rep.requests[rep.prof_req0] if rep.prof is not None else rep.t_end
        n = rep.prof_req0 if rep.prof is not None else rep.n_frames
        ctx.update(unprofiled=dict(
            frames=n, wall_s=cut - rep.t_start,
            spans={k: [d for t, d in v if t < cut] for k, v in rep.spans.items()},
            episodes=sum(1 for t in rep.episodes if t < cut),
            track_ms=[ms for t, ms in rep.track_ms if t < cut]))
        if profile is not None:
            ctx["profile"] = dict(profile, frames=rep.n_frames - rep.prof_req0, wall_s=rep.t_end - rep.prof_start,
                                  least_s=least)
    return ctx


def kernel_s(op_s):
    """Device seconds of each kernel in the profiled sub-window."""
    from gvins_bench.roofline import KERNELS

    return {k: sum(s for name, s in op_s.items() if kernel in name) for k, kernel in KERNELS.items()}


def run_cell(spec, seed, seconds, trace, device, control=False, fault=None, log=print):
    """Set up, measure and check one run of the cell ``spec`` (``cell_spec``)
    on ``device``: the result record (its ``checks`` last), with the
    control's readings under ``control`` when asked. ``fault(model)``, for
    tests, breaks the program as the window opens."""
    import torch

    from gvins_bench import check, render, roofline as rf, trace as tr, world as wd
    from gvins_bench.replay import Replay, WindowClosed

    cfg, traffic, limits = spec["cfg"], spec["traffic"], spec["limits"]
    workload = spec["cell"]["name"]
    cuda = torch.device(device).type == "cuda"
    if cuda:
        log(f"card: {card(torch)}; torch {torch.__version__} cuda {torch.version.cuda}")
    world = wd.build(cfg, traffic, seed)
    frames = render.render(world, cfg["camera"], traffic["blob"], device)
    log(f"world: {len(world['imu']['time'])} IMU samples, {len(world['gnss']['time'])} fixes, "
        f"{len(frames)} frames {frames.shape[2]}x{frames.shape[1]} held on the host ({frames.nbytes} B), "
        f"{len(world['points'])} street points; set-up so far {time.perf_counter() - T_PROCESS:.3f} s")
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    from ic_gvins_tpu_torch.engine.config import load_config
    from ic_gvins_tpu_torch.models.gvins import GvinsModel
    from ic_gvins_tpu_torch.utils import logger

    yaml = spec["yaml"]
    config = load_config(yaml)
    outdir = tempfile.mkdtemp(prefix=f"gvins_bench_{workload}_")
    try:
        shutil.copy(yaml, os.path.join(outdir, "gvins.yaml"))
        logger.initialize(outdir)
        model = GvinsModel(config, outdir=outdir, device=device)
        rep = Replay(model, world, frames, seconds, traffic, seed, trace=trace)
        rep.on_open = fault
        failed, error = 0, None
        try:
            model.run(world["imu"], world["gnss"], world["frame_times"], rep.provider)
            rep.finish_world()
        except WindowClosed:
            pass
        except Exception as e:  # noqa: BLE001 - a frame that raised inside the window is a failed frame
            if rep.phase != "window":
                raise
            failed, error = 1, f"{type(e).__name__}: {e}"
            rep.close(rep.cur_k + 1, time.perf_counter())
        if rep.phase == "warm":
            raise RuntimeError("the world ended before the window opened: lengthen the traffic's world_s")
        if cuda:
            torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        rep.captures_to_host()
        setup_s = rep.t_start - T_PROCESS
        if rep.world_ended:
            log(f"the world ended before the deadline: the window closed after {rep.wall_s:.3f} s")
        if error:
            log(f"a frame raised inside the window: {error}")
        iv = rep.frame_intervals_ms()
        half = len(iv) // 2
        log(f"frame intervals: median {np.median(iv):.3f} ms, quartiles {np.percentile(iv, 25):.3f}-"
            f"{np.percentile(iv, 75):.3f} ms, max {iv.max():.3f} ms; mean of the first half {iv[:half].mean():.3f} ms, "
            f"of the second {iv[half:].mean():.3f} ms; host CPUs {sorted(os.sched_getaffinity(0))}")
        c0, c1 = rep.counters0, rep.counters1
        log(f"window: frames {rep.k0}-{rep.k_end} ({rep.n_frames}), {rep.sim_s:.3f} sim-s in {rep.wall_s:.3f} s; "
            f"episodes {c1['episodes'] - c0['episodes']} (full tier {c1['full_tier'] - c0['full_tier']}), "
            f"marginalizations {c1['margs'] - c0['margs']}; device peak {peak} B")

        profile = least = None
        if trace and rep.prof is not None:
            profile = tr.read(rep.prof, SPAN_LABELS)
            if profile is not None:
                least, skipped = rf.least_s_by_kernel(rep.kernel_args, frames, device)
                log(f"kernel calls of the profiled sub-window: {[len(v) for v in rep.kernel_args.values()]} "
                    f"(clahe_apply, lk_pyr, subpix), {skipped} left out (frame unknown)")
                measured = kernel_s(profile["op_s"])
                for k in least:
                    share = 100 * least[k] / measured[k] if measured[k] else None
                    log(f"kernel {k}: least {least[k]:.9f} s, measured {measured[k]:.9f} s in the profiled "
                        f"sub-window, share of roofline {share} % (H100 SXM 3.35 TB/s, 67 TFLOP/s f32)")
        ctx = context(rep, setup_s, profile, least)
        wanted = spec["layer"] if trace else spec["e2e"]
        metrics = {}
        for m in wanted:
            value = reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = dict(value=float(value), unit=m["unit"])

        trajectory = list(model.trajectory)
        t0, t1 = world["frame_times"][rep.k0], world["frame_times"][min(rep.k_end, len(frames) - 1)]
        captures = rep.captures
        del model, rep.model, rep.prof
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(outdir, ignore_errors=True)

    log(f"ate_rmse_m (the window's nodes against the truth, not compared): "
        f"{check.ate_reading(trajectory, world, t0, t1)}")
    model_imu = check.imu_model(Path(yaml).read_text())
    values = check.readings(captures, frames, world, model_imu)
    ok, checks = check.verdict(values, limits)
    record = dict(correct=bool(ok and failed == 0), attempted=int(rep.n_frames), failed=failed, metrics=metrics,
                  device=dict(platform="gpu" if cuda else "cpu",
                              kind=torch.cuda.get_device_name(0) if cuda else "cpu",
                              count=1, memory_peak_bytes=int(peak)))
    if profile is not None:
        record["device"].update(busy_s=profile["busy_s"], window_s=ctx["profile"]["wall_s"])
        record["breakdown"] = dict(device_ops=tr.top(profile["op_s"]), idle_gaps=tr.top(profile["gap_s"]))
    if control:
        record["control"] = check.readings(captures, frames, world, model_imu, control=True)
    record["checks"] = checks
    return record


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    spec = cell_spec(args.workload)
    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: the cell needs {chips} CUDA device(s), torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    record = run_cell(spec, args.seed, args.seconds, bool(args.trace), "cuda", control=bool(args.control))
    found = forbidden_modules()
    if found:
        print(f"no result: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in record["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
