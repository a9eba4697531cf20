"""Sliding-window estimator: host bookkeeping + fixed-shape device work.

Port of ``ic_gvins_tpu/engine/estimator.py`` (the GVINS orchestrator's
window management, IC-GVINS ``ic_gvins.cc:724-928, 1412-1695``), for the
methods the GNSS/INS replay calls. The host keeps the authoritative mirror of
the window (node times, poses, mixes, GNSS entries, IMU segments, the
preintegration table) in numpy; preintegration, the LM solve, reintegration
and marginalization run on the device on padded tables. Every episode copies
what it needs to the device in one transfer (``host.upload``: a copy, never
an alias of the in-place-mutated mirrors) and reads back what
the host needs in one transfer (``host.fetch``). The marginalization prior
stays on the device.
"""

import numpy as np
import torch

from ..core.types import ImuBatch, NavState
from ..factors import marginalization as marg
from ..ins import preintegration as pre
from ..ins import preintegration_odo as pre_odo
from ..solver import lm
from ..solver.problem import (
    FactorTables,
    GnssTable,
    MargPrior,
    PreintTable,
    PriorTable,
    ReprojTable,
    WindowConfig,
    WindowParams,
    empty_preint_summary,
)
from ..utils import timecost
from .host import fetch, upload

MINIMUM_TIME_INTERVAL = 1.0e-4
REPROJ_COLS = 18


def _np_tree(tree):
    """Writable numpy copy of a NamedTuple of numpy arrays or CPU tensors."""
    return type(tree)(*[np.array(a, np.float64) for a in tree])


def _np_set(tree, idx, leaf_tree):
    """In-place row write on a NamedTuple of numpy arrays (host mirror edit)."""
    for a, v in zip(tree, leaf_tree):
        a[idx] = v


def _np_roll(tree, shift):
    """In-place roll-left on a NamedTuple of numpy arrays."""
    for a in tree:
        a[:] = np.roll(a, -shift, axis=0)


def _pack_rows(tree):
    """A NamedTuple of numpy arrays with a shared leading dim -> one (P, K)
    array, row-major per leaf, leaves in field order. np.concatenate
    copies."""
    P = tree[0].shape[0]
    return np.concatenate([np.asarray(a, np.float64).reshape(P, -1) for a in tree], axis=1)


def _unpack_rows(packed, template):
    """(P, K) device rows -> a NamedTuple shaped like ``template``."""
    out, o = [], 0
    for a in template:
        k = int(np.prod(a.shape[1:], dtype=np.int64))
        out.append(packed[:, o:o + k].reshape(a.shape))
        o += k
    return type(template)(*out), o


def _empty_reproj_rows(R):
    rows = np.zeros((R, REPROJ_COLS))
    rows[:, 1] = 1.0       # obs_idx
    rows[:, [5, 8]] = 1.0  # pts0.z, pts1.z
    return rows


class GnssEntry:
    __slots__ = ("time", "blh", "std")

    def __init__(self, time, blh, std):
        self.time = float(time)
        self.blh = np.asarray(blh, np.float64)
        self.std = np.asarray(std, np.float64)


class SlidingWindowEstimator:
    """Fixed-slot sliding window over time nodes, GNSS and preintegrations.

    Node slot k holds (time, pose, mix); interval slot k the IMU segment and
    preintegration summary linking node k -> k+1. Device work runs on
    ``device``."""

    def __init__(self, wcfg: WindowConfig, int_params, *, preint_samples=512,
                 antlever=np.zeros(3), origin=None, device="cuda"):
        self.wcfg = wcfg
        self.device = torch.device(device)
        self.int_params = type(int_params)(*[a.to(self.device) for a in int_params])
        self._bias_std = fetch(self.int_params.gyr_bias_std, self.int_params.acc_bias_std)
        self.S = preint_samples
        self.antlever = np.asarray(antlever, np.float64)
        self.origin = origin  # blh of world origin (for earth-rate per interval)

        # host mirrors
        self.n_nodes = 0
        self.times = np.zeros(wcfg.N)
        self.poses = np.zeros((wcfg.N, 7))
        self.poses[:, 6] = 1.0
        self.mixes = np.zeros((wcfg.N, wcfg.mix_dim))
        self.gnss_entries = []  # list[GnssEntry]
        # interval tables: numpy host mirrors, mutated in place by the window
        # bookkeeping and copied to the device once per episode
        self.preint_table = PreintTable(summ=_np_tree(empty_preint_summary(wcfg)),
                                        idx0=np.zeros(wcfg.P, np.int64), valid=np.zeros(wcfg.P))
        self.seg_store = _np_tree(ImuBatch.zeros((wcfg.P, preint_samples)))
        # the solver tier of the JAX package; for a GNSS/INS window (L = R = 8)
        # it equals the full tier
        self.wcfg_small = wcfg._replace(L=min(wcfg.L, max(64, wcfg.L // 2)),
                                        R=min(wcfg.R, max(256, wcfg.R // 2)))
        self.marg_prior = None  # MargPrior on the device, or None
        self._no_prior = {}     # per tier: the empty MargPrior on the device
        self.prior_cfg = None   # dict for init priors, or None
        self.ext = np.concatenate([np.zeros(3), np.array([0, 0, 0, 1.0])])
        self.td = 0.0
        self.invdepths = np.full(wcfg.L, 0.1)  # of the last solve, at its tier
        self.last_solve_times = (0.0, 0.0)  # (pass 1 s, surgery + pass 2 s), set by optimize
        self.last_iterations = (0, 0)       # accepted LM steps (pass 1, pass 2), set by optimize

    # ------------------------------------------------------------------
    # node management
    # ------------------------------------------------------------------

    def check_time_consistency(self, where="", raise_on_fail=False):
        """Every active preintegration interval must match the node times
        (summ.dt == times[k+1] - times[k], summ.end_time == times[k+1]); a
        structural edit that desynchronizes them produces silently wrong
        factors. Returns the list of violations."""
        msgs = []
        dts = self.preint_table.summ.dt
        ends = self.preint_table.summ.end_time
        valid = self.preint_table.valid
        for k in range(self.n_nodes - 1):
            gap = self.times[k + 1] - self.times[k]
            if valid[k] != 1.0:
                msgs.append(f"interval {k} invalid (nodes {self.times[k]:.3f}->{self.times[k+1]:.3f})")
            elif abs(dts[k] - gap) > 1e-6:
                msgs.append(f"interval {k}: summ.dt {dts[k]:.4f} != node gap {gap:.4f}")
            elif abs(ends[k] - self.times[k + 1]) > 1e-6:
                msgs.append(f"interval {k}: end_time {ends[k]:.4f} != times[k+1] {self.times[k+1]:.4f}")
        for k in range(max(self.n_nodes - 1, 0), self.wcfg.P):
            if valid[k] != 0.0:
                msgs.append(f"interval {k} beyond window still valid")
        if msgs and raise_on_fail:
            raise AssertionError(f"[{where}] " + "; ".join(msgs))
        return msgs

    def reset_first_node(self, time, state: NavState):
        """Seed node 0 (gvinsInitialization, ic_gvins.cc:652-671)."""
        self.n_nodes = 1
        self.times[0] = time
        self.poses[0] = np.concatenate([np.asarray(state.p), np.asarray(state.q)])
        parts = [np.asarray(state.v), np.asarray(state.bg), np.asarray(state.ba)]
        if self.wcfg.with_odo:
            parts.append(np.asarray(state.sodo, np.float64).reshape(1))
        self.mixes[0] = np.concatenate(parts)

    def node_state(self, k) -> NavState:
        """Node k as a NavState of numpy copies of the host mirror."""
        pose, mix = self.poses[k], self.mixes[k]
        sodo = np.float64(mix[9]) if self.wcfg.with_odo else np.float64(0.0)
        return NavState(time=np.float64(self.times[k]), p=pose[:3].copy(), q=pose[3:7].copy(),
                        v=mix[:3].copy(), bg=mix[3:6].copy(), ba=mix[6:9].copy(),
                        sodo=sodo, sg=np.zeros(3), sa=np.zeros(3))

    def latest_state(self) -> NavState:
        return self.node_state(self.n_nodes - 1)

    def set_prior(self, pose_prior, pose_std, mix_prior, mix_std):
        """constructPrior (ic_gvins.cc:1911-1936)."""
        n = self.wcfg.mix_dim
        self.prior_cfg = dict(pose_prior=np.asarray(pose_prior, np.float64),
                              pose_prior_std=np.asarray(pose_std, np.float64),
                              mix_prior=np.asarray(mix_prior, np.float64)[:n],
                              mix_prior_std=np.asarray(mix_std, np.float64)[:n])

    def _segment_iewn(self, state0_p):
        if not self.wcfg.with_earth or self.origin is None:
            return np.zeros(3)
        from ..core import earth_np

        return earth_np.iewn(self.origin, state0_p)

    def _preintegrate(self, ks):
        """Preintegrate the stored segments of interval slots ``ks`` from their
        start nodes in one batched device call; write the summaries into the
        host mirror (the odometer variant with ``with_odo``). Returns the
        summaries (numpy)."""
        ks = list(ks)
        segs = [np.stack([self.seg_store[i][k] for k in ks]) for i in range(len(ImuBatch._fields))]
        sts = [self.node_state(k) for k in ks]
        st_arrays = [np.stack([np.asarray(getattr(s, f), np.float64) for s in sts]) for f in NavState._fields]
        iewn = np.stack([self._segment_iewn(self.poses[k, :3]) for k in ks])
        dev = upload(segs + st_arrays + [iewn], self.device)
        imu = ImuBatch(*dev[:5])
        st0 = NavState(*dev[5:14])
        if self.wcfg.with_odo:
            summ = pre_odo.preintegrate_odo(self.int_params, imu, st0, with_earth=self.wcfg.with_earth,
                                            iewn=dev[14])
        else:
            summ = pre.preintegrate_batch(self.int_params, imu, st0, with_earth=self.wcfg.with_earth,
                                          iewn_batch=dev[14])
        summ = type(summ)(*fetch(*summ))
        for j, k in enumerate(ks):
            _np_set(self.preint_table.summ, k, [a[j] for a in summ])
        return summ

    def add_time_node(self, time, imu_series: dict):
        """Append a node at ``time``; imu_series: numpy dict (time, dt, dtheta,
        dvel, odovel) covering (times[-1], time], sample 0 the anchor
        (addNewTimeNode, ic_gvins.cc:897-928). Returns the new node's
        NavState, from the preintegration's absolute end state."""
        assert 1 <= self.n_nodes < self.wcfg.N, "window full"
        k = self.n_nodes - 1  # interval slot
        seg = self._pad_segment(imu_series)
        _np_set(self.seg_store, k, [seg[f] for f in ImuBatch._fields])
        summ = self._preintegrate([k])
        self.preint_table.idx0[k] = k
        self.preint_table.valid[k] = 1.0

        self.n_nodes += 1
        self.times[self.n_nodes - 1] = time
        self.poses[self.n_nodes - 1] = np.concatenate([summ.end_p[0], summ.end_q[0]])
        self.mixes[self.n_nodes - 1] = np.concatenate([summ.end_v[0], self.mixes[k, 3:]])
        return self.latest_state()

    def segment_samples(self, k):
        """Samples stored for interval slot ``k`` (its anchor included), or
        None if the slot holds no interval (the JAX package's
        ``segments_np[k] is None``)."""
        if self.preint_table.valid[k] != 1.0:
            return None
        return int(np.sum(self.seg_store.dt[k] > 0)) + 1

    def _pad_segment(self, series):
        S = self.S
        n = len(series["time"])
        assert n <= S, f"segment too long: {n} > {S}"
        out = {}
        for f in ImuBatch._fields:
            a = np.asarray(series[f], np.float64)
            out[f] = np.concatenate([a, np.zeros((S - n,) + a.shape[1:])], axis=0)
        out["dt"][0] = 0.0  # the anchor sample never integrates
        return out

    def add_gnss(self, time, blh_local, std):
        self.gnss_entries.append(GnssEntry(time, blh_local, std))

    # ------------------------------------------------------------------
    # table assembly
    # ------------------------------------------------------------------

    def _node_index_of_time(self, time):
        diffs = np.abs(self.times[: self.n_nodes] - time)
        k = int(np.argmin(diffs))
        return k if diffs[k] < MINIMUM_TIME_INTERVAL else -1

    def _gnss_rows(self, wc):
        """(G, 8) [node, blh(3), std(3), valid] rows of the GNSS entries that
        sit on a node, in entry order."""
        rows = np.zeros((wc.G, 8))
        rows[:, 4:7] = 1.0
        slot = 0
        for entry in self.gnss_entries:
            k = self._node_index_of_time(entry.time)
            if k < 0 or slot >= wc.G:
                continue
            rows[slot, 0] = k
            rows[slot, 1:4] = entry.blh
            rows[slot, 4:7] = entry.std
            rows[slot, 7] = 1.0
            slot += 1
        return rows

    def build_tables(self, *, ext_active=False, td_active=False, reproj_table=None,
                     reproj_sqrt_info=1.0, lm_valid=None, wc=None) -> FactorTables:
        """The episode's FactorTables on the device, from one host -> device
        copy. reproj_table: packed (R, 18) rows (the JAX package's
        ``gvins._build_reproj_table`` layout) or None for the empty table.
        wc: the table tier (self.wcfg or self.wcfg_small)."""
        wc = wc or self.wcfg
        pt = self.preint_table
        packed_preint = np.concatenate([_pack_rows(pt.summ), pt.idx0[:, None].astype(np.float64),
                                        pt.valid[:, None]], axis=1)
        rows = _empty_reproj_rows(wc.R) if reproj_table is None else reproj_table
        pc = self.prior_cfg
        if pc is None:
            pr = np.concatenate([[0.0], [0, 0, 0, 0, 0, 0, 1.0], np.ones(6), np.zeros(wc.mix_dim),
                                 np.ones(wc.mix_dim)])
        else:
            pr = np.concatenate([[1.0], pc["pose_prior"], pc["pose_prior_std"], pc["mix_prior"],
                                 pc["mix_prior_std"]])
        flags = [self.n_nodes - 1, float(ext_active), float(td_active), reproj_sqrt_info]
        lmv = np.zeros(wc.L) if lm_valid is None else lm_valid
        d_preint, d_gnss, d_reproj, d_pr, d_flags, d_lever, d_lmv = upload(
            [packed_preint, self._gnss_rows(wc), rows, pr, flags, self.antlever, lmv], self.device)

        summ, o = _unpack_rows(d_preint, self.preint_table.summ)
        preint = PreintTable(summ=summ, idx0=d_preint[:, o].long(), valid=d_preint[:, o + 1])
        one = torch.ones((), dtype=torch.float64, device=self.device)
        gnss = GnssTable(idx=d_gnss[:, 0].long(), blh=d_gnss[:, 1:4], std=d_gnss[:, 4:7],
                         valid=d_gnss[:, 7], robust=one)
        reproj = ReprojTable(
            ref_idx=d_reproj[:, 0].long(), obs_idx=d_reproj[:, 1].long(), lm_idx=d_reproj[:, 2].long(),
            pts0=d_reproj[:, 3:6], pts1=d_reproj[:, 6:9], vel0=d_reproj[:, 9:12], vel1=d_reproj[:, 12:15],
            td0=d_reproj[:, 15], td1=d_reproj[:, 16], valid=d_reproj[:, 17], sqrt_info=d_flags[3],
            robust=one)
        m = wc.mix_dim
        prior = PriorTable(pose_prior=d_pr[1:8], pose_prior_std=d_pr[8:14], mix_prior=d_pr[14:14 + m],
                           mix_prior_std=d_pr[14 + m:14 + 2 * m], valid=d_pr[0],
                           imuerr_idx=d_flags[0].long(), imuerr_valid=one)
        node_valid = (torch.arange(wc.N, device=self.device) < self.n_nodes).to(torch.float64)
        mp = self.marg_prior
        if mp is None:
            if wc not in self._no_prior:
                self._no_prior[wc] = MargPrior.empty(wc, self.device)
            mp = self._no_prior[wc]
        elif mp.x0.invdepths.shape[0] != wc.L:
            # the prior is landmark-free (NP support only); x0's invdepths
            # never reach the cost, so it is resized to the tier
            mp = mp._replace(x0=mp.x0._replace(invdepths=torch.zeros(wc.L, dtype=torch.float64,
                                                                     device=self.device)))
        return FactorTables(gnss=gnss, preint=preint, reproj=reproj, prior=prior, marg=mp,
                            antlever=d_lever, node_valid=node_valid, lm_valid=d_lmv,
                            ext_active=d_flags[1], td_active=d_flags[2])

    def build_params(self, invdepths=None, wc=None) -> WindowParams:
        """The window's parameters on the device (one copy of the mirrors)."""
        wc = wc or self.wcfg
        inv = np.full(wc.L, 0.1) if invdepths is None else invdepths
        return WindowParams(*upload([self.poses, self.mixes, self.ext, self.td, inv], self.device))

    # ------------------------------------------------------------------
    # optimize / reintegrate / marginalize
    # ------------------------------------------------------------------

    def _store_params(self, params: WindowParams, *extra):
        """Read the solved parameters into the host mirrors, with ``extra``
        tensors in the same transfer (returned as numpy)."""
        self.poses, self.mixes, self.ext, td, self.invdepths, *rest = fetch(
            params.poses, params.mixes, params.ext, params.td, params.invdepths, *extra)
        self.td = float(td)
        return rest

    def optimize(self, num_iterations=50, *, two_pass=False, tables=None, params=None, wc=None):
        """One optimization episode; updates the host state (``poses``,
        ``mixes``, ``ext``, ``td``, ``invdepths``) in one read. Returns
        (params, tables, stats). wc: the tier of tables/params (default full).
        A two-pass episode also sets ``last_iterations`` (accepted LM steps
        of each pass) and ``last_solve_times`` on the host, in the same
        read."""
        wc = wc or self.wcfg
        tables = self.build_tables(wc=wc) if tables is None else tables
        params = self.build_params(wc=wc) if params is None else params
        if two_pass:
            # pass 1 / surgery / pass 2 timed apart (statistics.txt cols 10-11:
            # pass 1, then surgery + pass 2, ic_gvins.cc:1019-1022): n/4
            # robust, the rest de-robustified. Each solve ends in its last
            # `done` read, so the spans bracket the device work too.
            n1 = max(num_iterations // 4, 1)
            n2 = max(num_iterations - n1, 1)
            with timecost.Span("lm.pass1") as pass1:
                params, s1, _ = lm.solve(params, tables, wc, n1)
            with timecost.Span("lm.surgery") as surgery:
                tables2, n_gnss_out, n_reproj_out = lm.outlier_surgery(params, tables, wc)
            with timecost.Span("lm.pass2") as pass2:
                params, s2, _ = lm.solve(params, tables2, wc, n2)
            self.last_solve_times = (pass1.seconds, surgery.seconds + pass2.seconds)
            stats = (s1, s2, n_gnss_out, n_reproj_out)
            g = tables2.gnss
            stds, idxs, valid, it1, it2 = self._store_params(params, g.std, g.idx, g.valid,
                                                             s1.iterations, s2.iterations)
            self.last_iterations = (int(it1), int(it2))
            self._absorb_gnss_stds(stds, idxs, valid)   # the reference mutates gnsslist_
        else:
            params, stats, _ = lm.solve(params, tables, wc, num_iterations)
            tables2 = tables
            self._store_params(params)
        return params, tables2, stats

    def _absorb_gnss_stds(self, stds, idxs, valid):
        """Persist pass 2's GNSS std inflation (host arrays of the surgery's
        GnssTable) into the entries it was built from."""
        slot = 0
        for entry in self.gnss_entries:
            k = self._node_index_of_time(entry.time)
            if k < 0 or slot >= self.wcfg.G:
                continue
            if valid[slot] > 0 and idxs[slot] == k:
                entry.std = stds[slot].copy()
            slot += 1

    def reintegrate_if_needed(self, sigma=6.0):
        """doReintegration (ic_gvins.cc:1680-1695): re-run the preintegration
        of intervals whose linearization biases moved > sigma * bias std, all
        in one batched device call. Returns how many."""
        P = self.wcfg.P
        n_int = self.n_nodes - 1
        if n_int <= 0:
            return 0
        dbg = np.linalg.norm(self.mixes[:P, 3:6] - self.preint_table.summ.bg0, axis=1)
        dba = np.linalg.norm(self.mixes[:P, 6:9] - self.preint_table.summ.ba0, axis=1)
        need = ((dbg > sigma * self._bias_std[0]) | (dba > sigma * self._bias_std[1])) & (np.arange(P) < n_int)
        if not need.any():
            return 0
        self._preintegrate(np.nonzero(need)[0])
        return int(need.sum())

    @timecost.traced("marg.schur")
    def marginalize(self, num_marg, oldest_kf_node=0, tables=None, params=None, wc=None):
        """Marginalize nodes [0, num_marg) and shift the window left. Returns
        the (device) mask of marginalized landmarks. wc: the tier of
        tables/params (default full); the prior's support is the same at
        either tier."""
        wc = wc or self.wcfg
        if num_marg <= 0:
            return None
        if num_marg > self.wcfg.marg_cap:
            raise ValueError(
                f"num_marg={num_marg} exceeds marg_cap={self.wcfg.marg_cap}: the structured Schur "
                f"factors only the leading marg_cap node blocks; pre-merge surplus nodes before "
                f"marginalizing")
        tables = self.build_tables(wc=wc) if tables is None else tables
        params = self.build_params(wc=wc) if params is None else params
        marg_tables, mask, lm_m = marg.select_marg_factors(tables, wc, num_marg, oldest_kf_node)
        prior = marg.marginalize(params, marg_tables, mask, wc)
        self.marg_prior = marg.shift_prior(prior, wc, num_marg)
        self.prior_cfg = None  # init priors absorbed (ic_gvins.cc:1537-1549)

        last_time = self.times[num_marg]
        n = self.n_nodes
        self.times[: n - num_marg] = self.times[num_marg:n]
        self.poses[: n - num_marg] = self.poses[num_marg:n]
        self.mixes[: n - num_marg] = self.mixes[num_marg:n]
        self.n_nodes = n - num_marg
        self.gnss_entries = [e for e in self.gnss_entries if e.time > last_time - MINIMUM_TIME_INTERVAL]
        # interval mirrors shift too (slot k always links k -> k+1, so idx0 stays)
        _np_roll(self.preint_table.summ, num_marg)
        self.preint_table.valid[:] = np.roll(self.preint_table.valid, -num_marg)
        self.preint_table.valid[self.wcfg.P - num_marg:] = 0.0
        _np_roll(self.seg_store, num_marg)
        return lm_m

    # ------------------------------------------------------------------
    # structure edits of the visual pipeline (insertNewGnssTimeNode,
    # removeUnusedTimeNode)
    # ------------------------------------------------------------------

    def insert_prior_slot(self, k):
        """Remap the prior after a mid-interval node insertion at slot ``k``
        (``marg.insert_node_slot_into_prior``), after checking that its last
        node slot is free (one read)."""
        if self.marg_prior is None:
            return
        marg.check_insert_capacity(self.marg_prior, self.wcfg)
        self.marg_prior = marg.insert_node_slot_into_prior(self.marg_prior, self.wcfg, int(k))

    def truncate_to(self, k):
        """Drop nodes [k, n_nodes) and their intervals (the node-removal leg
        of insertNewGnssTimeNode, ic_gvins.cc:864-876); host mirrors only.
        Returns the dropped node times, for the caller to re-add."""
        assert 1 <= k <= self.n_nodes
        dropped = list(self.times[k:self.n_nodes])
        self.preint_table.valid[max(k - 1, 0):] = 0.0
        self.n_nodes = k
        return dropped

    def merge_node(self, k):
        """Remove interior node ``k`` by merging intervals k-1 and k
        (removeUnusedTimeNode, ic_gvins.cc:754-789): the two segments joined
        and re-padded into slot k-1 and re-preintegrated from node k-1 (one
        batched device call and its read), the node and interval mirrors
        rolled left over k, and node k Schur-marginalized out of the prior
        with its columns compacted (``marg.drop_node_from_prior``)."""
        assert 1 <= k <= self.n_nodes - 1
        na, nb = self.segment_samples(k - 1), self.segment_samples(k)
        merged = {f: np.concatenate([self.seg_store[i][k - 1][:na], self.seg_store[i][k][1:nb]], axis=0)
                  for i, f in enumerate(ImuBatch._fields)}
        seg = self._pad_segment(merged)
        _np_set(self.seg_store, k - 1, [seg[f] for f in ImuBatch._fields])
        self._preintegrate([k - 1])   # from node k-1, which the roll below leaves in place

        n = self.n_nodes
        self.times[k:n - 1] = self.times[k + 1:n]
        self.poses[k:n - 1] = self.poses[k + 1:n]
        self.mixes[k:n - 1] = self.mixes[k + 1:n]
        self.n_nodes = n - 1
        # interval slots above k move one left; the last slot empties
        for a in (*self.preint_table.summ, self.preint_table.valid, *self.seg_store):
            a[k:-1] = a[k + 1:].copy()
            a[-1] = 0
        self.preint_table.valid[k - 1] = 1.0
        if self.marg_prior is not None:
            self.marg_prior = marg.drop_node_from_prior(self.marg_prior, self.wcfg, int(k))
