"""The port's checkpoint/resume on the CPU, on the estimator history of
tests/test_checkpoint.py:build_estimator (a 4-node GNSS/INS window with
init priors), also after one marginalization (a live prior on the device):
the port's round trip is bit for bit (the resumed estimator's next optimize
equals the original's with atol=0); a JAX checkpoint loads into the port,
whose next optimize matches the JAX one with the JAX solver's f64 mode
patched in (as tests/test_torch_gins.py does) within 1e-9 m; a port
checkpoint loads into the JAX estimator with every field equal; and the two
packages write the same keys and the same ``seg_valid``."""

import functools

import jax
import numpy as np
import pytest
import torch

import synthetic as syn
from test_checkpoint import build_estimator
from test_torch_harness import jax_compile_cache  # noqa: F401 (autouse: the run's compile cache)
from ic_gvins_tpu.engine import checkpoint as jckpt
from ic_gvins_tpu.engine import estimator as jest
from ic_gvins_tpu.solver import lm as jlm
from ic_gvins_tpu_torch import convert
from ic_gvins_tpu_torch.core.types import NavState
from ic_gvins_tpu_torch.engine import checkpoint as tckpt
from ic_gvins_tpu_torch.engine.estimator import SlidingWindowEstimator
from ic_gvins_tpu_torch.solver.problem import WindowConfig

torch.set_num_threads(1)
LEVER = np.array([0.1, 0.0, 0.2])
_precise_solve_jit = functools.partial(jax.jit, static_argnums=(2, 3))(
    lambda p, t, wc, iters: jlm.solve(p, t, wc, iters, precise=True)[:2])


def port_estimator(wcfg):
    params = convert.integration_params(jax.tree_util.tree_map(np.asarray, syn.default_params()), "cpu")
    return SlidingWindowEstimator(WindowConfig(*wcfg), params, preint_samples=128, antlever=LEVER, device="cpu")


def build_port(seed=0, marg=False):
    """build_estimator's history on the port's estimator, optimized (and
    with one node marginalized when ``marg``)."""
    est = port_estimator(build_estimator(seed)[1])
    rng = np.random.default_rng(seed)
    imu = syn.smooth_imu(201, 0.005, seed=seed)
    st0 = NavState.identity()._replace(v=torch.tensor(rng.normal(0, 1, 3)))
    est.reset_first_node(0.0, st0)
    est.set_prior(np.concatenate([st0.p.numpy(), st0.q.numpy()]), np.full(6, 0.1), np.zeros(9), np.full(9, 0.1))
    for k in range(3):
        a, b = k * 60, (k + 1) * 60
        est.add_time_node(float(imu.time[b]), {f: np.asarray(getattr(imu, f))[a:b + 1] for f in imu._fields})
        est.add_gnss(float(imu.time[b]), est.poses[est.n_nodes - 1, :3], np.full(3, 0.1))
    est.optimize(num_iterations=10)
    if marg:
        est.marginalize(1)
    return est


def build_jax(seed=0, marg=False):
    est, wcfg = build_estimator(seed)
    est.optimize(num_iterations=10)
    if marg:
        est.marginalize(1)
    return est, wcfg


def leaves(tree):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize("marg", [False, True])
def test_port_roundtrip_is_bit_for_bit(tmp_path, marg):
    est = build_port(marg=marg)
    path = str(tmp_path / "ckpt.npz")
    tckpt.save_checkpoint(path, est, extra=dict(stream_cursor=1234))
    est2 = port_estimator(build_estimator()[1])
    extra = tckpt.load_checkpoint(path, est2)
    assert int(extra["stream_cursor"]) == 1234
    assert est2.n_nodes == est.n_nodes and (est2.marg_prior is None) == (not marg)
    for a, b in ((est2.times, est.times), (est2.poses, est.poses), (est2.mixes, est.mixes), (est2.ext, est.ext)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(leaves(est2.preint_table) + leaves(est2.seg_store), leaves(est.preint_table) + leaves(est.seg_store)):
        assert a.dtype == b.dtype and a.flags.writeable
        np.testing.assert_array_equal(a, b)
    if marg:
        for a, b in zip(est2.marg_prior, est.marg_prior):
            for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
                assert x.device == est2.device and torch.equal(x, y)
    assert [(e.time, *e.blh, *e.std) for e in est2.gnss_entries] == [(e.time, *e.blh, *e.std) for e in est.gnss_entries]
    # the resumed estimator continues identically
    p1, _, s1 = est.optimize(num_iterations=5)
    p2, _, s2 = est2.optimize(num_iterations=5)
    np.testing.assert_allclose(p1.poses.numpy(), p2.poses.numpy(), atol=0)
    assert float(s1.final_cost) == float(s2.final_cost) and int(s1.iterations) == int(s2.iterations)


@pytest.mark.parametrize("marg", [False, True])
def test_jax_checkpoint_resumes_in_port(tmp_path, monkeypatch, marg):
    jest_, wcfg = build_jax(marg=marg)
    path = str(tmp_path / "jax.npz")
    jckpt.save_checkpoint(path, jest_, extra=dict(stream_cursor=7))
    est = port_estimator(wcfg)
    assert int(tckpt.load_checkpoint(path, est)["stream_cursor"]) == 7
    assert est.preint_table.idx0.dtype == np.int64 and est.preint_table.idx0.flags.writeable
    monkeypatch.setattr(jest, "_solve_jit", _precise_solve_jit)
    jp, _, js = jest_.optimize(num_iterations=5)
    tp, _, ts = est.optimize(num_iterations=5)
    np.testing.assert_allclose(tp.poses.numpy(), np.asarray(jp.poses), atol=1e-9)
    np.testing.assert_allclose(est.mixes, jest_.mixes, atol=1e-9)
    assert int(ts.iterations) == int(js.iterations)


@pytest.mark.parametrize("marg", [False, True])
def test_port_checkpoint_loads_in_jax(tmp_path, marg):
    est = build_port(marg=marg)
    path = str(tmp_path / "port.npz")
    tckpt.save_checkpoint(path, est)
    jest_, _ = build_estimator()
    jckpt.load_checkpoint(path, jest_)
    assert jest_.n_nodes == est.n_nodes and jest_.td == est.td
    for name in ("times", "poses", "mixes", "ext"):
        np.testing.assert_array_equal(getattr(jest_, name), getattr(est, name))
    assert len(jest_.gnss_entries) == len(est.gnss_entries)
    for a, b in zip(jest_.gnss_entries, est.gnss_entries):
        assert a.time == b.time and np.array_equal(a.blh, b.blh) and np.array_equal(a.std, b.std)
    for a, b in zip(leaves(jest_.preint_table) + leaves(jest_.seg_store),
                    leaves(est.preint_table) + leaves(est.seg_store)):
        np.testing.assert_array_equal(a, b)
    if marg:
        assert jest_.prior_cfg is None and est.prior_cfg is None
        for a, b in zip(leaves(jest_.marg_prior), jax.tree_util.tree_leaves(est.marg_prior)):
            np.testing.assert_array_equal(a, b.numpy())
    else:
        assert jest_.marg_prior is None
        for k, v in est.prior_cfg.items():
            np.testing.assert_array_equal(jest_.prior_cfg[k], v)
    assert [s is not None for s in jest_.segments_np] == [est.segment_samples(k) is not None
                                                          for k in range(est.wcfg.P)]


@pytest.mark.parametrize("marg", [False, True])
def test_key_sets_and_seg_valid_match_jax(tmp_path, marg):
    jest_, _ = build_jax(marg=marg)
    est = build_port(marg=marg)
    jckpt.save_checkpoint(str(tmp_path / "j.npz"), jest_, extra=dict(a=1))
    tckpt.save_checkpoint(str(tmp_path / "t.npz"), est, extra=dict(a=1))
    j, t = np.load(str(tmp_path / "j.npz")), np.load(str(tmp_path / "t.npz"))
    assert set(j.files) == set(t.files) and "seg_valid" in t.files
    assert any(k.startswith("marg_") for k in t.files) == marg
    np.testing.assert_array_equal(t["seg_valid"], j["seg_valid"])
    assert t["seg_valid"].sum() == (3 if not marg else 2)
    for k in j.files:
        assert j[k].shape == t[k].shape, k
