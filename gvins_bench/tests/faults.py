"""Faults planted in the program as the window opens, each of a kind the
replay cells can have; the check has to read every one as not correct."""

import numpy as np
import torch


def ins_state_unchanged(model):
    """The INS propagation steps through its samples and returns its state
    unchanged."""
    from ic_gvins_tpu_torch.engine.host import fetch

    prop = model.prop

    def propagate_to(t_end, sample_cb=None):
        end = prop.stream.index_after(t_end + 1.0e-4)
        if prop.cursor >= end:
            return
        n = end - prop.cursor
        if sample_cb is not None:
            p, q, v = fetch(prop.state.p, prop.state.q, prop.state.v)
            sample_cb(prop.stream.time[prop.cursor:end], np.tile(p, (n, 1)), np.tile(q, (n, 1)), np.tile(v, (n, 1)))
        prop._time_host = prop.stream.time[end - 1]
        prop.cursor = end
    prop.propagate_to = propagate_to


def solve_state_unchanged(model):
    """Every window solve returns the window's state unchanged."""
    def optimize(num_iterations=50, *, two_pass=False, tables=None, params=None, wc=None):
        return params, tables, None
    model.est.optimize = optimize


def solve_half_reprojection(model):
    """Every window solve leaves out every other reprojection factor of its
    tables."""
    original = model.est.optimize

    def optimize(num_iterations=50, *, two_pass=False, tables=None, params=None, wc=None):
        if tables is not None:
            valid = tables.reproj.valid.clone()
            valid[1::2] = 0.0
            tables = tables._replace(reproj=tables.reproj._replace(valid=valid))
        return original(num_iterations, two_pass=two_pass, tables=tables, params=params, wc=wc)
    model.est.optimize = optimize


def prior_left_out(model):
    """Every marginalization leaves a prior with no information."""
    est = model.est
    original = est.marginalize

    def marginalize(*args, **kwargs):
        out = original(*args, **kwargs)
        if est.marg_prior is not None:
            est.marg_prior = est.marg_prior._replace(H0=torch.zeros_like(est.marg_prior.H0),
                                                     Jte0=torch.zeros_like(est.marg_prior.Jte0))
        return out
    est.marginalize = marginalize


def _wrap_lk(change):
    from ic_gvins_tpu_torch.vision import lk

    original = lk.lk_pyr

    def lk_pyr(pyr_prev, pyr_next, pts_prev, pts_pred, valid, **kw):
        return change(original, pyr_prev, pyr_next, pts_prev, pts_pred, valid, **kw)
    lk.lk_pyr = lk_pyr


def lk_half_batch(model):
    """LK tracks every other slot of its batch and reports the rest lost."""
    def change(fn, pyr_prev, pyr_next, pts_prev, pts_pred, valid, **kw):
        half = valid.clone()
        half[1::2] = False
        return fn(pyr_prev, pyr_next, pts_prev, pts_pred, half, **kw)
    _wrap_lk(change)


def lk_answer_altered(model):
    """LK's tracked points are moved by a quarter pixel where they are
    produced."""
    def change(fn, *args, **kw):
        fwd, ok = fn(*args, **kw)
        return fwd + torch.tensor([0.25, 0.0], device=fwd.device), ok
    _wrap_lk(change)
