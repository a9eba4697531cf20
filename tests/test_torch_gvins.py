"""The port's GNSS-visual-inertial replay (``GvinsModel``) on the CPU, against
the JAX package: the world and configuration of tests/test_gvins_e2e.py
(320x240 rendered blobs over a flat background, camera = body, extrinsic and
td estimation off), its drive cut to 14 s
(``make_gins_dataset(turn_duration=8.0)``: the window still fills to
TRACKING_NORMAL and marginalizes): ``world()`` and ``raw_cfg``, which
tests/test_torch_gvins_twin.py replays in both packages. Here: the
estimator's structure edits (``truncate_to``, ``merge_node``,
``insert_prior_slot``) against the JAX estimator, the extrinsic/td sanity
gates, chip_smoke.py's copy of the renderer and the entry point's device
default.

Tolerances, each against the JAX twin: the estimator's host mirrors after
each edit: times and segments equal, poses/mixes/preintegration summaries
1e-8 (of scale), as tests/test_torch_gins.py's slot-by-slot test, and 1e-7
after the last solve (observed 1.4e-8); the prior after
``insert_prior_slot`` (a permutation) equal; after ``merge_node`` (a Schur
step that the JAX package factors in f32 and refines) H0/Jte0 within 1e-9 of
their scale, x0 equal.
"""

import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gins_data import make_gins_dataset
from test_gvins_e2e import FX, H, W, render_frame
from test_torch_gins import _precise_solve_jit
from test_torch_harness import jax_compile_cache  # noqa: F401 (autouse: the run's compile cache)
from ic_gvins_tpu.core import quaternion as jquat
from ic_gvins_tpu.engine import estimator as jest
from ic_gvins_tpu.engine.replay import ImuStream
from ic_gvins_tpu.vision import camera as jcam
from ic_gvins_tpu_torch import convert
from ic_gvins_tpu_torch.engine.config import parse_config as tparse
from ic_gvins_tpu_torch.engine.estimator import SlidingWindowEstimator as TEst
from ic_gvins_tpu_torch.models.gvins import GvinsModel as TGvins

torch.set_num_threads(1)
RATE = 200.0


def raw_cfg(truth, **kw):
    """tests/test_gvins_e2e.py's configuration."""
    return {**dict(initlength=3, imudatarate=200, iswithearth=False, antlever=list(truth["lever"]),
                   imumodel=dict(arw=0.1, vrw=0.1, gbstd=400.0, abstd=400.0, corrtime=1.0),
                   gnssthreshold=20, optimize_windows_size=8, optimize_num_iterations=20,
                   optimize_estimate_extrinsic=False, optimize_estimate_td=False, is_use_visualization=True,
                   track_min_parallax=20, track_max_interval=0.5, track_max_features=120,
                   reprojection_error_std=1.5, node_slots=20, landmark_slots=256, gnss_slots=20,
                   reproj_slots=1024,
                   cam0=dict(intrinsic=[FX, FX, 160.0, 120.0], distortion=[-0.05, 0.01, 0.0, 0.0],
                             resolution=[W, H], q_b_c=[0.0, 0.0, 0.0, 1.0], t_b_c=[0.0, 0.0, 0.0],
                             td_b_c=0.0)), **kw}


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def world():
    """The 14 s drive, the ground scene of tests/test_gvins_e2e.py and its
    rendered frames at 10 Hz (rendered once, shared by both replays)."""
    imu, gnss, truth = make_gins_dataset(turn_duration=8.0)
    rng = np.random.default_rng(42)
    pts_w = np.stack([rng.uniform(-10, 55, 800), rng.uniform(-25, 25, 800), rng.uniform(9, 13, 800)], axis=1)
    camera = jcam.PinholeCamera.from_config([FX, FX, 160.0, 120.0], [-0.05, 0.01, 0.0, 0.0], [W, H])
    frame_times = np.arange(0.05, imu["time"][-1] - 0.2, 0.1)
    images = []
    for t in frame_times:
        i = min(int(round(t * RATE)) - 1, len(truth["p"]) - 1)
        Rwb = np.asarray(jquat.to_matrix(jnp.asarray(truth["q"][i])))
        images.append(render_frame(camera, pts_w, Rwb, truth["p"][i]))
    return imu, gnss, truth, frame_times, images


def spy(mp, cls, name, log, what):
    """Wrap cls.name so that each call appends what(self, result) to log."""
    fn = getattr(cls, name)

    @functools.wraps(fn)
    def wrapped(self, *args, **kw):
        out = fn(self, *args, **kw)
        log.append(what(self, out))
        return out
    mp.setattr(cls, name, wrapped)


def _state(self, _):
    return self.state, self.est.n_nodes if self.est else 0


def _twin_estimators():
    """One window built identically in both packages from the 14 s drive's
    IMU: nodes at 4-10 s with GNSS, a two-pass solve (the JAX solve in f64
    mode), then one marginalization, so a prior is present; the JAX prior is
    then carried into the port (``convert.marg_prior``), so both hold the
    same one."""
    from ic_gvins_tpu.core.types import IntegrationParams as JParams
    from ic_gvins_tpu.core.types import NavState as JNav
    from ic_gvins_tpu.solver.problem import WindowConfig as JWC
    from ic_gvins_tpu_torch.solver.problem import WindowConfig as TWC

    imu, _, truth = make_gins_dataset(turn_duration=8.0)
    stream = ImuStream(imu)
    shape = dict(N=10, L=8, G=10, R=8, with_earth=False)
    jparams = JParams.default()._replace(gravity=jnp.asarray(9.7936))
    tparams = convert.integration_params(np_tree(jparams), "cpu")
    lever = truth["lever"]
    je = jest.SlidingWindowEstimator(JWC(**shape), jparams, preint_samples=512, antlever=lever)
    te = TEst(TWC(**shape), tparams, preint_samples=512, antlever=lever, device="cpu")
    q0 = np.array([0.0, 0.0, np.sin(0.05), np.cos(0.05)])
    st0 = dict(time=np.float64(4.0), p=np.zeros(3), q=q0, v=np.zeros(3), bg=np.full(3, 1e-3),
               ba=np.zeros(3), sodo=np.float64(0.0), sg=np.zeros(3), sa=np.zeros(3))
    je.reset_first_node(4.0, JNav(**st0))
    te.reset_first_node(4.0, convert.nav_state(st0, "cpu"))
    pose_std = np.array([0.1, 0.1, 0.1, 0.01, 0.01, 0.03])
    mix_std = np.concatenate([np.full(3, 0.1), np.full(3, 1e-3), np.full(3, 0.2)])
    for e in (je, te):
        e.set_prior(np.concatenate([st0["p"], q0]), pose_std, np.zeros(9), mix_std)

    def gnss_at(t):
        return truth["gnss_local"][int(t) - 1] - truth["gnss_local"][3]

    for t in (5.0, 6.0, 7.0, 8.0, 9.0, 10.0):
        for e in (je, te):
            e.add_time_node(t, stream.series(e.times[e.n_nodes - 1], t))
            e.add_gnss(t, gnss_at(t), np.full(3, 0.02))
    mp = pytest.MonkeyPatch()
    mp.setattr(jest, "_solve_jit", _precise_solve_jit)
    try:
        je.optimize(20, two_pass=True)
    finally:
        mp.undo()
    te.optimize(20, two_pass=True)
    je.marginalize(1)
    te.marginalize(1)
    te.marg_prior = convert.marg_prior(np_tree(je.marg_prior), "cpu")
    return je, te, stream, gnss_at


def _same_mirrors(te, je, tol=1e-8):
    assert te.n_nodes == je.n_nodes
    np.testing.assert_array_equal(te.times, je.times)
    np.testing.assert_allclose(te.poses, je.poses, atol=tol, rtol=0)
    np.testing.assert_allclose(te.mixes, je.mixes, atol=tol, rtol=0)
    for a, b in zip(te.preint_table.summ, je.preint_table.summ):
        np.testing.assert_allclose(a, b, atol=tol * max(1.0, np.abs(b).max()), rtol=0)
    np.testing.assert_array_equal(te.preint_table.valid, je.preint_table.valid)
    for k in range(te.wcfg.P):
        seg = je.segments_np[k]
        assert (te.segment_samples(k) is None) == (seg is None), k
        if seg is not None:
            assert te.segment_samples(k) == int(np.sum(seg["dt"] > 0)) + 1
            for f, a in zip(seg, te.seg_store):
                np.testing.assert_array_equal(a[k], seg[f])
    assert te.check_time_consistency() == je.check_time_consistency() == []


def _prior_leaves(pr):
    return [np.asarray(x) for x in (pr.H0, pr.Jte0, pr.c0, *pr.x0, pr.valid)]


def test_convert_marg_prior_carries_every_leaf():
    je, te, _, _ = _twin_estimators()
    for a, b in zip(_prior_leaves(te.marg_prior), _prior_leaves(je.marg_prior)):
        np.testing.assert_array_equal(a, b)
    assert all(t.dtype == torch.float64 and t.device.type == "cpu"
               for t in (te.marg_prior.H0, te.marg_prior.Jte0, *te.marg_prior.x0))


def test_structure_edits_match_jax_estimator():
    """merge_node (a second-new node removed), then a mid-interval GNSS node
    insertion (truncate_to, the re-added tail, insert_prior_slot), then one
    more solve: the host mirrors and the prior follow the JAX estimator."""
    je, te, stream, gnss_at = _twin_estimators()
    _same_mirrors(te, je)

    # removeUnusedTimeNode: node 2 (t = 7 s) of 5..10 s merged away
    assert te.times[2] == 7.0
    for e in (je, te):
        e.merge_node(2)
    _same_mirrors(te, je)
    np.testing.assert_array_equal(te.times[:te.n_nodes], [5.0, 6.0, 8.0, 9.0, 10.0])
    H0 = np.asarray(je.marg_prior.H0)
    scale = float(np.abs(H0).max())
    np.testing.assert_allclose(te.marg_prior.H0.numpy(), H0, atol=1e-9 * scale, rtol=0)
    np.testing.assert_allclose(te.marg_prior.Jte0.numpy(), np.asarray(je.marg_prior.Jte0),
                               atol=1e-9 * max(1.0, float(np.abs(np.asarray(je.marg_prior.Jte0)).max())),
                               rtol=0)
    for a, b in zip(te.marg_prior.x0, je.marg_prior.x0):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    # insertNewGnssTimeNode, mid-interval: a fix at 8.5 s inside (8, 9]
    te.marg_prior = convert.marg_prior(np_tree(je.marg_prior), "cpu")
    index = 3
    for e in (je, te):
        dropped = e.truncate_to(index)
        np.testing.assert_array_equal(dropped, [9.0, 10.0])
        e.add_time_node(8.5, stream.series(e.times[index - 1], 8.5))
        e.add_gnss(8.5, gnss_at(8.0), np.full(3, 0.02))
        for t in dropped:
            e.add_time_node(t, stream.series(e.times[e.n_nodes - 1], t))
        e.insert_prior_slot(index)
    _same_mirrors(te, je)
    np.testing.assert_array_equal(te.times[:te.n_nodes], [5.0, 6.0, 8.0, 8.5, 9.0, 10.0])
    for a, b in zip(_prior_leaves(te.marg_prior), _prior_leaves(je.marg_prior)):
        np.testing.assert_array_equal(a, b)

    mp = pytest.MonkeyPatch()
    mp.setattr(jest, "_solve_jit", _precise_solve_jit)
    try:
        je.optimize(20, two_pass=True)
    finally:
        mp.undo()
    te.optimize(20, two_pass=True)
    _same_mirrors(te, je, tol=1e-7)     # the solves' rounding: observed 1.4e-8 (accelerometer bias)
    assert te.last_iterations[0] >= 1


def _gate_model(ext=True, td=True):
    imu, _, truth = make_gins_dataset(turn_duration=2.0)
    m = TGvins(tparse(raw_cfg(truth, optimize_estimate_extrinsic=ext, optimize_estimate_td=td,
                                is_use_visualization=False)), device="cpu")
    from ic_gvins_tpu_torch.core.types import integration_params_from_config
    from ic_gvins_tpu_torch.solver.problem import WindowConfig as TWC

    m.est = TEst(TWC(N=4, L=8, G=4, R=8, with_earth=False), integration_params_from_config(m.cfg),
                 device="cpu")
    m.est.reset_first_node(1.0, convert.nav_state(dict(
        time=np.float64(1.0), p=np.zeros(3), q=np.array([0.0, 0.0, 0.0, 1.0]), v=np.zeros(3),
        bg=np.zeros(3), ba=np.zeros(3), sodo=np.float64(0.0), sg=np.zeros(3), sa=np.zeros(3)), "cpu"))
    m.state = "TRACKING_NORMAL"
    return m


@pytest.mark.parametrize("td_b_c, td_new, adopted", [
    (0.0, 0.0199, True), (0.0, -0.0201, False),     # the step gate: |td_new - td| <= 0.02 s
    (0.07, 0.0799, True), (0.07, 0.0801, False),    # the range gate: |td_new| <= 0.08 s
])
def test_td_gate(td_b_c, td_new, adopted):
    m = _gate_model(ext=False)
    m.td_b_c = td_b_c
    m.est.td = td_new
    m._update_from_optimizer({})
    assert m.td_b_c == (td_new if adopted else td_b_c)


@pytest.mark.parametrize("dt, dr_deg, adopted", [
    (0.99, 0.0, True), (1.01, 0.0, False),     # translation step <= 1 m
    (0.0, 4.9, True), (0.0, 5.1, False),       # rotation step <= 5 deg
])
def test_extrinsic_gate(dt, dr_deg, adopted):
    m = _gate_model(td=False)
    half = np.deg2rad(dr_deg) / 2
    R0, t0 = m.pose_b_c_R.copy(), m.pose_b_c_t.copy()
    m.est.ext = np.array([dt, 0.0, 0.0, 0.0, 0.0, np.sin(half), np.cos(half)])
    m._update_from_optimizer({})
    if adopted:
        np.testing.assert_allclose(m.pose_b_c_t, [dt, 0.0, 0.0])
        assert abs(np.degrees(np.arccos(np.clip((np.trace(m.pose_b_c_R) - 1) / 2, -1, 1))) - dr_deg) < 1e-9
    else:
        np.testing.assert_array_equal(m.pose_b_c_t, t0)
        np.testing.assert_array_equal(m.pose_b_c_R, R0)


def test_marginalize_beyond_marg_cap_raises():
    """More nodes than marg_cap are refused with a ValueError, not a wrong
    prior: GvinsModel pre-merges surplus nodes below the cap first."""
    est = _gate_model().est
    with pytest.raises(ValueError, match="marg_cap"):
        est.marginalize(est.wcfg.marg_cap + 1)


def test_chip_smoke_world_matches_e2e_renderer():
    """chip_smoke.py cannot import tests/test_gvins_e2e.py (jax); its scene
    and renderer, with the port's numpy camera and rotation, give the same
    frames of the 14 s drive within 1e-9 gray."""
    import chip_smoke
    from ic_gvins_tpu_torch.core import rotation_np
    from ic_gvins_tpu_torch.vision import camera as tcam

    _, _, truth, frame_times, images = world()
    camera = tcam.PinholeCamera.from_config(*chip_smoke.SMALL_CAMERA)
    times, frames = chip_smoke.gvins_frames(tcam, rotation_np, camera, truth, chip_smoke.e2e_scene(),
                                            chip_smoke.SMALL_BLOB)
    np.testing.assert_array_equal(times, frame_times)
    assert len(frames) == len(images)
    for a, b in zip(frames, images):
        np.testing.assert_allclose(a, b, atol=1e-9, rtol=0)


def test_entry_point_defaults_to_cuda():
    """GvinsModel runs on the card unless the caller asks for the CPU, its
    tracker too; without CUDA the first device op of run raises, nothing
    falls back."""
    assert inspect.signature(TGvins).parameters["device"].default == "cuda"
    imu, gnss, truth = make_gins_dataset(turn_duration=2.0)
    model = TGvins(tparse(raw_cfg(truth, is_use_visualization=False)))
    assert model.device.type == "cuda" and model.tracker.device.type == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            model.run(imu, gnss, np.zeros(0), lambda k: None)
