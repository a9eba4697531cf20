"""One replay of a world through ``GvinsModel.run``, with its measured window.

The run is a closed loop, as a replay of a log is: the estimator asks the
image provider for frame k + 1 once it has done all it does after frame k.
The provider is the harness's hook into the loop. It counts the warm-up
(the GNSS/INS and visual initialization, until the state is
``TRACKING_NORMAL``, and ``warm_frames`` frames more), then opens the window
at a frame request, records the time of every request, and closes the window
at the first request after the deadline by raising :class:`WindowClosed`,
which the caller catches: the program has no public way to stop or step a
replay. A world that ends before the deadline ends the window there.

While the window is open the harness keeps, for the correctness check,
copies of what the program's three kernels were given and gave on a few
frames drawn from the seed (the program writes later frames into the same
buffers; the copies are made in the window's first seconds, before any
profiling), a few INS propagations (state before, samples
out), a few preintegrations (node state and times, summary), and one
keyframe episode drawn from the seed: the factor tables and state its solve
was given and the state it returned, and the tables, state and prior of the
first marginalization after it. The episode's tables and states are held by
reference (the program makes them anew for every episode and never writes
into them), so keeping them costs the device no work. With ``trace`` it also
times the calls into the program's layers (spans, on the model's instance
and on the tracker's), and runs ``torch.profiler`` over the last
``profile_s`` seconds of the window only, so that the profiler's host cost
stays out of the spans and out of the unprofiled wall time per frame. In
that sub-window the kernels' calls are recorded by their frames' indices,
their shapes and references to their point tensors, never copied, so that
the profiled device work is the program's alone.
"""

import contextlib
import gc
import time

import numpy as np
import torch

from . import world as wd


class WindowClosed(Exception):
    """The provider was asked for a frame after the deadline."""


class Replay:
    def __init__(self, model, world, frames, seconds, traffic, seed, trace=False):
        self.model, self.world, self.frames = model, world, frames
        self.seconds, self.trace = float(seconds), bool(trace)
        self.warm_frames = int(traffic["warm_frames"])
        self.profile_s = float(traffic["profile_s"]) if trace else 0.0
        rng = wd.rng_for(seed, 2)
        lo, hi = traffic["check_frames"]
        self.kernel_marks = sorted(rng.choice(np.arange(lo, hi), traffic["check_samples"], replace=False).tolist())
        self.ins_marks = sorted(rng.choice(np.arange(lo, hi), traffic["check_samples"], replace=False).tolist())
        lo, hi = traffic["check_nodes"]
        self.node_marks = set(rng.choice(np.arange(lo, hi), traffic["check_samples"], replace=False).tolist())
        self.episode_mark = int(rng.integers(*traffic["check_episode"]))
        self.n_episodes = self.n_nodes = 0
        self.phase = "warm"
        self.warm_count = 0
        self.cur_k = -1
        self.k0 = self.k_end = None
        self.t_start = self.t_end = None
        self.requests = []            # perf_counter of every request in the window
        self.world_ended = False
        # correctness captures
        self.frame_of_ptr = {}        # CLAHE output address -> frame index
        self.armed = {"lk": False, "subpix": False, "ins": False, "marg": False}
        self.captures = {"lk": [], "subpix": [], "ins": [], "preint": [], "solve": None, "marg": None}
        # trace
        self.spans = {"episode": [], "ins": [], "track": []}
        self.episodes = []            # start time of each _optimize_visual call
        self.track_ms = []            # (start, the program's track_ms)
        self.prof = None
        self.prof_start = None
        self.kernel_args = {"clahe_apply": [], "lk_pyr": [], "subpix": []}
        self._restore = []
        self.on_open = None           # called with the model as the window opens (tests plant faults there)

    # ------------------------------------------------------------------
    # the provider
    # ------------------------------------------------------------------

    def provider(self, k):
        self.cur_k = k
        if self.phase == "warm":
            if self.model.state == "TRACKING_NORMAL":
                self.warm_count += 1
            if self.warm_count > self.warm_frames:
                # what set-up made lives to the end: keep the collector off it
                gc.collect()
                gc.freeze()
                self._open(k, time.perf_counter())
            return self.frames[k].astype(np.float64)
        now = time.perf_counter()
        n = len(self.requests)
        if now - self.t_start >= self.seconds:
            self.close(k, now)
            raise WindowClosed()
        self.requests.append(now)
        for kind, marks in (("lk", self.kernel_marks), ("subpix", self.kernel_marks), ("ins", self.ins_marks)):
            if n in marks:
                self.armed[kind] = True
        if self.trace and self.prof is None and now - self.t_start >= self.seconds - self.profile_s:
            self._start_profiler()
        return self.frames[k].astype(np.float64)

    def _open(self, k, now):
        self.phase = "window"
        self.k0, self.t_start = k, now
        self.requests.append(now)
        self.counters0 = self.counters()
        if self.on_open is not None:
            self.on_open(self.model)
        self._install()

    def close(self, k, now):
        """Close the window at frame ``k``, time ``now``."""
        self.phase = "closed"
        self.k_end, self.t_end = k, now
        if self.prof is not None:
            self._sync()
            self.prof.__exit__(None, None, None)
        self.counters1 = self.counters()
        self.uninstall()

    def captures_to_host(self):
        """Move the captured episode to the host, where its reference runs
        (after the window, before the program is freed). The kernels'
        captures stay on the device, where theirs runs."""
        for name in ("solve", "marg"):
            self.captures[name] = host(self.captures[name])

    def finish_world(self):
        """The replay returned before the deadline: the window ends at the
        world's last frame."""
        if self.phase == "window":
            self.world_ended = True
            self.close(len(self.world["frame_times"]), time.perf_counter())

    def counters(self):
        m = self.model
        return dict(episodes=sum(m.tier_counts.values()), full_tier=m.tier_counts["full"],
                    margs=sum(m.tier_counts_marg.values()))

    # ------------------------------------------------------------------
    # window quantities
    # ------------------------------------------------------------------

    @property
    def n_frames(self):
        """Frames handed over in the window."""
        return self.k_end - self.k0

    @property
    def wall_s(self):
        return self.t_end - self.t_start

    @property
    def sim_s(self):
        ft = self.world["frame_times"]
        end = ft[self.k_end] if self.k_end < len(ft) else ft[-1] + (ft[1] - ft[0])
        return float(end - ft[self.k0])

    def frame_intervals_ms(self):
        return 1e3 * np.diff(np.asarray(self.requests + [self.t_end]))

    # ------------------------------------------------------------------
    # wrappers (set on the program's objects while the window is open)
    # ------------------------------------------------------------------

    def _patch(self, owner, name, fn):
        had = name in vars(owner)
        self._restore.append((owner, name, getattr(owner, name), had))
        setattr(owner, name, fn)

    def uninstall(self):
        for owner, name, fn, had in reversed(self._restore):
            if had:
                setattr(owner, name, fn)
            else:
                delattr(owner, name)
        self._restore.clear()

    def _span(self, name):
        if self.prof is not None:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()

    def _timed(self, name, fn, on_start=None):
        spans = self.spans[name]

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            if on_start is not None:
                on_start(t0)
            with self._span(name):
                out = fn(*args, **kwargs)
            spans.append((t0, time.perf_counter() - t0))
            return out
        return timed

    def _install(self):
        from ic_gvins_tpu_torch.vision import features, lk, pyramid

        m = self.model
        self._patch(pyramid, "clahe_apply", self._clahe_wrapper(pyramid.clahe_apply))
        self._patch(lk, "lk_pyr", self._lk_wrapper(lk.lk_pyr))
        self._patch(features, "subpix", self._subpix_wrapper(features.subpix))
        self._patch(m.est, "optimize", self._optimize_wrapper(m.est.optimize))
        self._patch(m.est, "marginalize", self._marginalize_wrapper(m.est, m.est.marginalize))
        self._patch(m.est, "add_time_node", self._node_wrapper(m.est, m.est.add_time_node))
        propagate = self._ins_wrapper(m.prop, m.prop.propagate_to)
        if self.trace:
            propagate = self._timed("ins", propagate)
            self._patch(m, "_optimize_visual", self._timed("episode", m._optimize_visual, self.episodes.append))
            for name in ("_remove_second_new_frames", "_marginalize_visual"):
                self._patch(m, name, self._timed("episode", getattr(m, name)))
            track = m.tracker.track

            def traced_track(*args):
                t0 = time.perf_counter()
                with self._span("track"):
                    out = track(*args)
                self.track_ms.append((t0, m.tracker.track_ms))
                return out
            self._patch(m.tracker, "track", traced_track)
        self._patch(m.prop, "propagate_to", propagate)

    def _profiling_args(self, name):
        return self.kernel_args[name] if self.prof is not None else None

    def _clahe_wrapper(self, fn):
        def clahe_apply(v, lut, grid, tile):
            out = fn(v, lut, grid, tile)
            self.frame_of_ptr[out.data_ptr()] = self.cur_k
            args = self._profiling_args("clahe_apply")
            if args is not None:
                args.append((tuple(v.shape), v.element_size(), tuple(lut.shape), lut.element_size()))
            return out
        return clahe_apply

    def _lk_wrapper(self, fn):
        def lk_pyr(pyr_prev, pyr_next, pts_prev, pts_pred, valid, **kw):
            fwd, ok = fn(pyr_prev, pyr_next, pts_prev, pts_pred, valid, **kw)
            frames = (self.frame_of_ptr.get(pyr_prev[0].data_ptr()), self.frame_of_ptr.get(pyr_next[0].data_ptr()))
            args = self._profiling_args("lk_pyr")
            if args is not None:
                args.append((frames, len(pyr_prev), pts_prev, pts_pred, valid))
            if self.armed["lk"] and kw.get("directions") == 2:
                self.armed["lk"] = False
                # copies: the program writes later frames into the same buffers
                self.captures["lk"].append(dict(
                    args=([t.clone() for t in pyr_prev], [t.clone() for t in pyr_next], pts_prev.clone(),
                          pts_pred.clone(), valid.clone()), fwd=fwd.clone(), ok=ok.clone(), frames=frames))
            return fwd, ok
        return lk_pyr

    def _subpix_wrapper(self, fn):
        def subpix(img, corners, valid, iters=None):
            out = fn(img, corners, valid, iters=iters)
            frame = self.frame_of_ptr.get(img.data_ptr())
            args = self._profiling_args("subpix")
            if args is not None:
                args.append((frame, corners, valid))
            if self.armed["subpix"]:
                self.armed["subpix"] = False
                self.captures["subpix"].append(dict(args=(img.clone(), corners.clone(), valid.clone()),
                                                    out=out.clone(), frame=frame))
            return out
        return subpix

    def _optimize_wrapper(self, fn):
        def optimize(num_iterations=50, *, two_pass=False, tables=None, params=None, wc=None):
            keep = two_pass and tables is not None and params is not None and self.n_episodes == self.episode_mark
            self.n_episodes += bool(two_pass)
            out = fn(num_iterations, two_pass=two_pass, tables=tables, params=params, wc=wc)
            if keep:
                self.captures["solve"] = dict(tables=tree(tables), x=tree(params), out=tree(out[0]),
                                              iterations=num_iterations)
                self.armed["marg"] = True
            return out
        return optimize

    def _marginalize_wrapper(self, est, fn):
        def marginalize(num_marg, oldest_kf_node=0, tables=None, params=None, wc=None):
            out = fn(num_marg, oldest_kf_node, tables=tables, params=params, wc=wc)
            if self.armed["marg"] and tables is not None and params is not None and num_marg > 0:
                self.armed["marg"] = False
                self.captures["marg"] = dict(tables=tree(tables), x=tree(params), num_marg=int(num_marg),
                                             oldest=int(oldest_kf_node), H0=est.marg_prior.H0,
                                             Jte0=est.marg_prior.Jte0)
            return out
        return marginalize

    def _node_wrapper(self, est, fn):
        def add_time_node(time, imu_series):
            keep = self.n_nodes in self.node_marks
            self.n_nodes += 1
            if not keep:
                return fn(time, imu_series)
            k = est.n_nodes - 1
            state0 = dict(t0=float(est.times[k]), p=est.poses[k, :3].copy(), q=est.poses[k, 3:7].copy(),
                          v=est.mixes[k, :3].copy(), bg=est.mixes[k, 3:6].copy(), ba=est.mixes[k, 6:9].copy())
            out = fn(time, imu_series)
            summ = {f: np.array(getattr(est.preint_table.summ, f)[k]) for f in est.preint_table.summ._fields}
            self.captures["preint"].append(dict(state0, t1=float(time), summ=summ))
            return out
        return add_time_node

    def _ins_wrapper(self, prop, fn):
        stream = prop.stream

        def propagate_to(t_end, sample_cb=None):
            end_idx = stream.index_after(t_end + 1.0e-4)
            if not (self.armed["ins"] and sample_cb is not None and end_idx - prop.cursor >= 2):
                return fn(t_end, sample_cb=sample_cb)
            self.armed["ins"] = False
            st = prop.state
            state0 = {f: getattr(st, f).detach().cpu().numpy().copy() for f in ("p", "q", "v", "bg", "ba")}
            rec = dict(j0=prop.cursor, state0=state0, p=[], q=[], v=[])

            def cb(times, p, q, v):
                rec["p"].append(p.copy())
                rec["q"].append(q.copy())
                rec["v"].append(v.copy())
                return sample_cb(times, p, q, v)
            out = fn(t_end, sample_cb=cb)
            rec["j1"] = prop.cursor
            rec.update({f: np.concatenate(rec[f]) for f in ("p", "q", "v")})
            self.captures["ins"].append(rec)
            return out
        return propagate_to

    # ------------------------------------------------------------------
    # the profiled sub-window
    # ------------------------------------------------------------------

    def _sync(self):
        if self.model.device.type == "cuda":
            torch.cuda.synchronize()

    def _start_profiler(self):
        self._sync()
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.model.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=activities)
        self.prof.__enter__()
        self.prof_start = time.perf_counter()
        self.prof_req0 = len(self.requests) - 1


def tree(t):
    """A NamedTuple of tensors (nested) as nested dicts of the same tensors."""
    if isinstance(t, tuple) and hasattr(t, "_fields"):
        return {f: tree(getattr(t, f)) for f in t._fields}
    return t


def host(t):
    """Nested dicts and lists with every tensor moved to the host."""
    if isinstance(t, dict):
        return {k: host(v) for k, v in t.items()}
    if isinstance(t, list):
        return [host(v) for v in t]
    if isinstance(t, tuple):
        return tuple(host(v) for v in t)
    return t.detach().cpu() if torch.is_tensor(t) else t
