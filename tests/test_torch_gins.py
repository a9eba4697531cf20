"""The port's GNSS/INS replay on the CPU against the JAX package's: the
pieces that tests/test_torch_gins_twin.py (the replays' twins) and the fault
twins share (``raw_cfg``, ``assert_twins``, the tolerances ``PRECISE``, the
JAX estimator's f64 solve), one estimator episode driven by hand through
both packages, the entry-point guards and chip_smoke.py's copy of the world
generator (tests/gins_data.py's world).

``PRECISE``: the JAX package's production solve factors in f32 with one f64
refinement; the port factors in f64, as the JAX solver's ``precise=True``
mode does. Against that mode (patched into the JAX estimator) the replays
agree to rounding: node positions and velocities within 1e-8 m (m/s),
attitudes 1e-9, biases 1e-10 (observed ~1e-11 m)."""

import functools
import inspect

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from gins_data import make_gins_dataset
from test_torch_harness import jax_compile_cache  # noqa: F401 (autouse: the run's compile cache)
from ic_gvins_tpu.engine import estimator as jest
from ic_gvins_tpu.solver import lm as jlm
from ic_gvins_tpu_torch.engine.config import parse_config as tparse
from ic_gvins_tpu_torch.models.gins import GinsModel as TGins

torch.set_num_threads(1)
PRECISE = dict(pos=1e-8, att=1e-9, vel=1e-8, bg_xy=1e-10, bg_z=1e-10)
# the JAX estimator's solve in the JAX solver's f64 mode (one jit, shared by
# every run of this file)
_precise_solve_jit = functools.partial(jax.jit, static_argnums=(2, 3))(
    lambda p, t, wc, iters: jlm.solve(p, t, wc, iters, precise=True)[:2])


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def raw_cfg(truth, with_earth, **kw):
    return dict(initlength=3, imudatarate=200, iswithearth=with_earth, antlever=list(truth["lever"]),
                imumodel=dict(arw=0.1, vrw=0.1, gbstd=400.0, abstd=400.0, corrtime=1.0),
                gnssthreshold=20, optimize_windows_size=10, **kw)


def assert_twins(jm, jt, tm, tt, tol):
    assert tm.state == jm.state == "INITIALIZING_INS"
    assert tt.shape == jt.shape and len(tt) >= 4
    np.testing.assert_array_equal(tt[:, 0], jt[:, 0])                     # node times
    np.testing.assert_allclose(tt[:, 1:4], jt[:, 1:4], atol=tol["pos"])   # positions
    np.testing.assert_allclose(tt[:, 4:8], jt[:, 4:8], atol=tol["att"])   # attitudes
    assert tm.est.n_nodes == jm.est.n_nodes
    np.testing.assert_array_equal(tm.est.times, jm.est.times)
    np.testing.assert_allclose(tm.est.mixes[:, :3], jm.est.mixes[:, :3], atol=tol["vel"])
    k = tm.est.n_nodes - 1
    np.testing.assert_allclose(tm.est.mixes[k, 3:5], jm.est.mixes[k, 3:5], atol=tol["bg_xy"])
    np.testing.assert_allclose(tm.est.mixes[k, 5], jm.est.mixes[k, 5], atol=tol["bg_z"])
    assert tm.est.check_time_consistency() == []


def test_odometer_raises_and_entry_point_defaults_to_cuda():
    """isuseodo=True no longer raises: it builds the odometer window (10-dim
    mix blocks, 19-res preintegration; its replays are held against the JAX
    twin in tests/test_torch_odo_twin.py). GinsModel runs on the card unless the
    caller asks for the CPU, and without CUDA its first device op raises."""
    imu, gnss, truth = chip_smoke.gins_world(turn_duration=2.0)
    odo = TGins(tparse(raw_cfg(truth, False, isuseodo=True)), device="cpu")
    assert odo.wcfg.with_odo and odo.wcfg.mix_dim == 10 and odo.wcfg.preint_res == 19
    assert inspect.signature(TGins).parameters["device"].default == "cuda"
    model = TGins(tparse(raw_cfg(truth, False)))
    assert model.device.type == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            model.run(imu, gnss)


@pytest.mark.parametrize("with_earth", [False, True])
def test_chip_smoke_world_matches_gins_data(with_earth):
    """chip_smoke.py cannot import tests/gins_data.py (jax); its generator,
    built from the port, gives the same arrays within 1e-9. GNSS heights
    pass through ECEF coordinates of ~6.4e6 m, whose float64 spacing is
    9.3e-10 m: they agree within 1e-8 m."""
    ref = make_gins_dataset(with_earth=with_earth)
    port = chip_smoke.gins_world(with_earth=with_earth)
    for a, b in zip(port, ref):
        assert a.keys() == b.keys()
        for k in a:
            x, y = np.asarray(a[k], np.float64), np.asarray(b[k], np.float64)
            if k == "blh":
                np.testing.assert_allclose(x[:, 2], y[:, 2], atol=1e-8, rtol=0, err_msg="height")
                x, y = x[:, :2], y[:, :2]
            np.testing.assert_allclose(x, y, atol=1e-9, rtol=0, err_msg=k)


def test_estimator_episode_matches_jax_slot_by_slot():
    """One estimator driven by hand through both packages: the first 7 GNSS
    epochs of the 14 s world as time nodes, the two-pass optimization (the
    JAX solve in f64 mode), reintegration, a marginalization, two more
    nodes: the device tables equal the JAX package's slot by slot (1e-9 of
    scale), and the host mirrors after each step agree within 1e-8."""
    from ic_gvins_tpu.core.types import IntegrationParams as JParams
    from ic_gvins_tpu.core.types import NavState as JNav
    from ic_gvins_tpu.engine.replay import ImuStream
    from ic_gvins_tpu.solver.problem import WindowConfig as JWC
    from ic_gvins_tpu_torch import convert
    from ic_gvins_tpu_torch.engine.estimator import SlidingWindowEstimator as TEst
    from ic_gvins_tpu_torch.solver.problem import WindowConfig as TWC

    imu, gnss, truth = make_gins_dataset(turn_duration=8.0)
    stream = ImuStream(imu)
    wcj, wct = JWC(N=8, L=8, G=8, R=8, with_earth=False), TWC(N=8, L=8, G=8, R=8, with_earth=False)
    jparams = JParams.default()._replace(gravity=jax.numpy.asarray(9.7936))
    tparams = convert.integration_params(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    lever = truth["lever"]
    je = jest.SlidingWindowEstimator(wcj, jparams, preint_samples=512, antlever=lever)
    te = TEst(wct, tparams, preint_samples=512, antlever=lever, device="cpu")
    q0 = np.array([0.0, 0.0, np.sin(0.05), np.cos(0.05)])
    st0 = dict(time=np.float64(4.0), p=np.zeros(3), q=q0, v=np.zeros(3), bg=np.full(3, 1e-3),
               ba=np.zeros(3), sodo=np.float64(0.0), sg=np.zeros(3), sa=np.zeros(3))
    je.reset_first_node(4.0, JNav(**st0))
    te.reset_first_node(4.0, convert.nav_state(st0, "cpu"))
    pose_std = np.array([0.1, 0.1, 0.1, 0.01, 0.01, 0.03])
    mix_std = np.concatenate([np.full(3, 0.1), np.full(3, 1e-3), np.full(3, 0.2)])
    for e in (je, te):
        e.set_prior(np.concatenate([st0["p"], q0]), pose_std, np.zeros(9), mix_std)

    def add(t):
        g = truth["gnss_local"][int(t) - 1] - truth["gnss_local"][3]
        for e in (je, te):
            e.add_time_node(t, stream.series(e.times[e.n_nodes - 1], t))
            e.add_gnss(t, g, np.full(3, 0.02))

    def same_mirrors():
        assert te.n_nodes == je.n_nodes
        np.testing.assert_array_equal(te.times, je.times)
        np.testing.assert_allclose(te.poses, je.poses, atol=1e-8)
        np.testing.assert_allclose(te.mixes, je.mixes, atol=1e-8)
        for a, b in zip(te.preint_table.summ, je.preint_table.summ):
            np.testing.assert_allclose(a, b, atol=1e-8 * max(1.0, np.abs(b).max()))
        np.testing.assert_array_equal(te.preint_table.valid, je.preint_table.valid)

    for t in (5.0, 6.0, 7.0, 8.0, 9.0, 10.0):
        add(t)
    same_mirrors()
    tt, jt = te.build_tables(), je.build_tables()
    for name in ("gnss", "preint", "prior"):
        for a, b in zip(jax.tree_util.tree_leaves(tuple(getattr(tt, name))),
                        jax.tree_util.tree_leaves(np_tree(getattr(jt, name)))):
            np.testing.assert_allclose(np.asarray(a), b, atol=1e-9 * max(1.0, np.abs(b).max()))
    mp = pytest.MonkeyPatch()
    mp.setattr(jest, "_solve_jit", _precise_solve_jit)
    try:
        je.optimize(20, two_pass=True)
    finally:
        mp.undo()
    te.optimize(20, two_pass=True)
    same_mirrors()
    assert te.reintegrate_if_needed() == je.reintegrate_if_needed()
    same_mirrors()
    te.marginalize(1)
    je.marginalize(1)
    same_mirrors()
    np.testing.assert_allclose(te.marg_prior.H0.numpy(), np.asarray(je.marg_prior.H0),
                               atol=1e-6 * float(np.abs(np.asarray(je.marg_prior.H0)).max()))
    add(11.0)
    mp.setattr(jest, "_solve_jit", _precise_solve_jit)
    try:
        je.optimize(20)
    finally:
        mp.undo()
    te.optimize(20)
    same_mirrors()
    assert te.check_time_consistency() == je.check_time_consistency() == []
