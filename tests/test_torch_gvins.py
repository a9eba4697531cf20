"""The port's GNSS-visual-inertial replay (``GvinsModel``) on the CPU, against
the JAX package's ``GvinsModel`` and against the ground truth: the world and
configuration of tests/test_gvins_e2e.py (320x240 rendered blobs over a flat
background, camera = body, extrinsic and td estimation off), its drive cut to
14 s (``make_gins_dataset(turn_duration=8.0)``: the window still fills to
TRACKING_NORMAL and marginalizes). The JAX solve runs in its f64 mode
(``precise=True``) and the port's RANSAC draws the JAX package's hypothesis
table, so the two replays see the same frontend decisions. The JAX replay
runs in a child process with the CPU client's async dispatch off, which
makes it the same under any load of the machine (ROADMAP R3). Also: the
estimator's structure edits (``truncate_to``, ``merge_node``,
``insert_prior_slot``) against the JAX estimator, the reprojection-table
packing on every episode of the replay, the solve tiers, the extrinsic/td
sanity gates and the entry point's device default.

Tolerances, each against the JAX twin:
- the state after every frame, node times, keyframe episodes and tiers,
  statistics.txt rows with their stamps and frame ids, the packed
  reprojection rows and their count on the same map: equal;
- features of a keyframe and landmarks in the final map: within 2 (the JAX
  CPU LK culls tracks at its 48x128 gather block, the port does not;
  ROADMAP P1; observed: one landmark);
- positions 5e-5 m, attitudes (quaternion components) 2e-5, velocities 2e-5
  m/s: that landmark moves the window's solution (observed 8.5e-6 m,
  2.9e-6, 3.6e-6 m/s);
- the estimator's host mirrors after each edit: times and segments equal,
  poses/mixes/preintegration summaries 1e-8 (of scale), as
  tests/test_torch_gins.py's slot-by-slot test, and 1e-7 after the last
  solve (observed 1.4e-8); the prior after ``insert_prior_slot`` (a
  permutation) equal; after ``merge_node`` (a Schur step that the JAX package
  factors in f32 and refines) H0/Jte0 within 1e-9 of their scale, x0
  equal.
"""

import functools
import inspect
import os
import pickle
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gins_data import make_gins_dataset
from test_gvins_e2e import FX, H, W, render_frame
from test_torch_gins import _precise_solve_jit
from test_torch_harness import jax_child, jax_result, kill_if_running, module_reads
from test_torch_harness import jax_compile_cache  # noqa: F401 (autouse: the run's compile cache)
from test_torch_tracking import _jax_table
from ic_gvins_tpu.core import quaternion as jquat
from ic_gvins_tpu.engine import estimator as jest
from ic_gvins_tpu.engine.config import parse_config as jparse
from ic_gvins_tpu.engine.replay import ImuStream
from ic_gvins_tpu.models.gvins import GvinsModel as JGvins
from ic_gvins_tpu.vision import camera as jcam
from ic_gvins_tpu_torch import convert
from ic_gvins_tpu_torch.engine.config import parse_config as tparse
from ic_gvins_tpu_torch.engine.estimator import SlidingWindowEstimator as TEst
from ic_gvins_tpu_torch.models.gvins import GvinsModel as TGvins
from ic_gvins_tpu_torch.solver import lm as tlm
from ic_gvins_tpu_torch.solver import problem as tprob
from ic_gvins_tpu_torch.vision import ransac as transac

torch.set_num_threads(1)
RATE = 200.0
TWIN = dict(pos=5e-5, att=2e-5, vel=2e-5, features=2)
GVINS_CHILD_LIMIT = 420   # s: ~3x the JAX child's wall alone on an 8-core CPU (140.1 s)


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


def jax_replay(outdir, out_path):
    """The JAX replay of ``world()`` (its solve in f64) with output files
    and visualization on, into outdir; pickles to out_path its trajectory,
    the state after every frame and what the tests read of the model."""
    imu, gnss, truth, frame_times, images = world()
    log = []
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jest, "_solve_jit", _precise_solve_jit)
        spy(mp, JGvins, "_process_frame", log, _state)
        jm = JGvins(jparse(raw_cfg(truth)), outdir=outdir)
        jt = jm.run(imu, gnss, frame_times, lambda k: images[k])
    finally:
        mp.undo()
    model = dict(state=jm.state, tier_counts=jm.tier_counts, tier_counts_marg=jm.tier_counts_marg,
                 n_nodes=jm.est.n_nodes, times=jm.est.times, mixes=jm.est.mixes,
                 n_keyframes=len(jm.vmap.keyframes), n_landmarks=len(jm.vmap.landmarks),
                 n_fixed_points=len(jm.drawer.fixed_points))
    with open(out_path, "wb") as f:
        pickle.dump((model, np.asarray(jt), log), f)


@pytest.fixture(scope="module", autouse=True)
def jax_gvins_child(request, jax_compile_cache, tmp_path_factory):
    """The JAX replay (``jax_replay``) in a child process started with the
    module, so that it runs while the tests that need no replay, which come
    first, and the port's replay run: (child, its output directory, pickle
    path), or None where no test of the module reads the replays. Killed at
    the module's end if still running."""
    if not module_reads(request, "replays"):
        yield None
        return
    outdir = str(tmp_path_factory.mktemp("jax_gvins"))
    out_path = os.path.join(outdir, "jax_replay.pkl")
    child = jax_child("test_torch_gvins:jax_replay", outdir, out_path)
    yield child, outdir, out_path
    kill_if_running(child)


@pytest.mark.slow
def test_jax_twin_is_the_same_under_load(tmp_path):
    """ROADMAP R3: the fixture's JAX replay run alone, then four copies at
    once with the CPU client's async dispatch off (as the fixture runs it),
    then four with it on. Prints each copy's largest position difference to
    the run alone; the copies with it off equal it bit for bit."""
    def runs(tag, dispatch, n):
        kids = []
        for i in range(n):
            d = tmp_path / f"{tag}{i}"
            d.mkdir()
            kids.append((jax_child("test_torch_gvins:jax_replay", str(d), str(d / "out.pkl"), dispatch=dispatch),
                         str(d / "out.pkl")))
        return [jax_result(child, path, timeout=1200)[1] for child, path in kids]

    alone = runs("alone", "sync", 1)[0]
    diffs = {}
    for dispatch in ("sync", "async"):
        diffs[dispatch] = [float(np.abs(t[:, 1:4] - alone[:, 1:4]).max()) if t.shape == alone.shape else float("inf")
                           for t in runs(dispatch, dispatch, 4)]
    print(f"\nfour copies at once against the run alone, largest position difference (m): {diffs}")
    assert diffs["sync"] == [0.0] * 4


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


# The replays' twins come last: the JAX child runs while the tests above do.
@pytest.fixture(scope="module")
def replays(jax_gvins_child, tmp_path_factory):
    """Both replays with output files and visualization on: the JAX one in
    the child of ``jax_gvins_child`` (``jm`` is what it reports of its
    model), the port's here meanwhile. The port's run also packs every
    episode's reprojection table with the JAX function on the port's own
    map and window."""
    child, jdir, out_path = jax_gvins_child
    dirs = (jdir, str(tmp_path_factory.mktemp("port_gvins")))
    logs = {"port": [], "packs": []}

    def packed_by_jax(self, out):
        slots = self._lm_slots
        proxy = types.SimpleNamespace(wcfg=self.wcfg, est=self.est, vmap=self.vmap, camera=self.camera)
        return out, JGvins._build_reproj_table(proxy, slots)

    mp = pytest.MonkeyPatch()
    try:
        imu, gnss, truth, frame_times, images = world()
        mp.setattr(transac, "_draw_samples", lambda valid, num_hyp, generator:
                   torch.tensor(np.asarray(_jax_table(jnp.asarray(valid.numpy())))))
        spy(mp, TGvins, "_process_frame", logs["port"], _state)
        spy(mp, TGvins, "_build_reproj_table", logs["packs"], packed_by_jax)
        tm = TGvins(tparse(raw_cfg(truth)), outdir=dirs[1], device="cpu")
        tt = tm.run(imu, gnss, frame_times, lambda k: images[k])
    finally:
        mp.undo()
        model, jt, logs["jax"] = jax_result(child, out_path, timeout=GVINS_CHILD_LIMIT)
    return types.SimpleNamespace(**model), jt, tm, tt, truth, dirs, logs


def test_replay_matches_jax_twin(replays):
    jm, jt, tm, tt, _, _, logs = replays
    assert tm.state == jm.state == "TRACKING_NORMAL"
    assert logs["port"] == logs["jax"]                                   # state after every frame
    assert tm.tier_counts == jm.tier_counts and tm.tier_counts_marg == jm.tier_counts_marg
    assert sum(tm.tier_counts.values()) >= 10 and sum(tm.tier_counts_marg.values()) >= 3
    assert tt.shape == jt.shape
    np.testing.assert_array_equal(tt[:, 0], jt[:, 0])                      # node times
    np.testing.assert_allclose(tt[:, 1:4], jt[:, 1:4], atol=TWIN["pos"], rtol=0)
    np.testing.assert_allclose(tt[:, 4:8], jt[:, 4:8], atol=TWIN["att"], rtol=0)
    assert tm.est.n_nodes == jm.n_nodes
    np.testing.assert_array_equal(tm.est.times, jm.times)
    np.testing.assert_allclose(tm.est.mixes[:, :3], jm.mixes[:, :3], atol=TWIN["vel"], rtol=0)
    assert len(tm.vmap.keyframes) == jm.n_keyframes
    assert abs(len(tm.vmap.landmarks) - jm.n_landmarks) <= TWIN["features"]
    assert tm.est.check_time_consistency() == []


def test_replay_accuracy_and_outputs(replays):
    """The gates of tests/test_gvins_e2e.py on the port's run, and its
    output files against the JAX run's: the same rows of statistics.txt,
    tracking.txt and gvins.nav, the reference column counts, and the
    drawer's artifacts."""
    jm, _, tm, tt, truth, (jdir, tdir), _ = replays
    idx = np.round(tt[:, 0] * RATE).astype(int) - 1
    err = np.linalg.norm(tt[:, 1:4] + truth["gnss_local"][0] - truth["p"][idx], axis=1)
    assert err.mean() < 0.12 and err.max() < 0.4, err
    assert len(tm.vmap.landmarks) >= 10
    assert 2 <= len(tm.vmap.keyframes) <= tm.cfg.optimize_windows_size + 1
    load = lambda d, n: np.atleast_2d(np.loadtxt(os.path.join(d, n)))  # noqa: E731
    js, ts = load(jdir, "statistics.txt"), load(tdir, "statistics.txt")
    assert ts.shape == js.shape and ts.shape[1] == 15 and len(ts) >= 3
    assert np.median(ts[:, 6]) < 3.0
    np.testing.assert_array_equal(ts[:, :3], js[:, :3])                   # stamps, gaps, frame ids
    assert np.abs(ts[:, 3] - js[:, 3]).max() <= TWIN["features"]          # features of the keyframe
    assert (ts[:, 10] > 0).all() and (ts[:, 11] > 0).all() and (ts[:, 12] > 0).any()
    jk, tk = load(jdir, "tracking.txt"), load(tdir, "tracking.txt")
    assert tk.shape == jk.shape and tk.shape[1] == 7
    jn, tn = load(jdir, "gvins.nav"), load(tdir, "gvins.nav")
    assert tn.shape == jn.shape and tn.shape[1] == 11
    np.testing.assert_array_equal(tn[:, :2], jn[:, :2])
    assert os.path.getsize(os.path.join(tdir, "mappoint.txt")) > 0
    assert len(load(tdir, "mappoint.txt")) == len(load(jdir, "mappoint.txt"))
    pngs = lambda d: sorted(os.listdir(os.path.join(d, "tracking")))  # noqa: E731
    assert pngs(tdir) == pngs(jdir) and len(pngs(tdir)) >= 2
    assert os.path.exists(os.path.join(tdir, "path.png"))
    assert len(tm.drawer.fixed_points) == jm.n_fixed_points > 0


def test_reproj_packing_matches_jax_on_every_episode(replays):
    """``_build_reproj_table``: the packed (R, 18) rows and the row count of
    every call of the port's replay (optimization episodes and
    marginalization rebuilds) equal the JAX function's on the same map."""
    *_, logs = replays
    assert len(logs["packs"]) >= 10
    assert max(n for (_, n), _ in logs["packs"]) > 50
    for (packed, nrows), (jpacked, jnrows) in logs["packs"]:
        assert nrows == jnrows
        np.testing.assert_array_equal(packed, np.asarray(jpacked))


def test_solve_tiers_agree(replays):
    """The window of the finished replay solved at the small tier (the
    tables truncated) and at the full tier (the prior's x0.invdepths resized
    by build_tables): the same cost and, after three LM iterations, the same
    node states within 1e-9."""
    _, _, tm, _, _, _, _ = replays
    est = tm.est
    slots, inv, lmv = tm._assign_landmark_slots(count_optimized=False)
    reproj, nrows = tm._build_reproj_table(slots)
    assert nrows > 0 and est.marg_prior.x0.invdepths.shape[0] == est.wcfg_small.L < est.wcfg.L
    out = {}
    for wc in (est.wcfg_small, est.wcfg):
        tables = est.build_tables(reproj_table=reproj[:wc.R], reproj_sqrt_info=tm.reproj_sqrt_info,
                                  lm_valid=lmv[:wc.L], wc=wc)
        params = est.build_params(invdepths=inv[:wc.L], wc=wc)
        assert tables.marg.x0.invdepths.shape[0] == wc.L
        cost = float(tprob.total_cost(params, tables, wc))
        solved, _, _ = tlm.solve(params, tables, wc, 3)
        out[wc.L] = cost, solved.poses.numpy(), solved.mixes.numpy()
    (cs, ps, ms), (cf, pf, mf) = out[est.wcfg_small.L], out[est.wcfg.L]
    np.testing.assert_allclose(cf, cs, rtol=1e-12)
    np.testing.assert_allclose(pf, ps, atol=1e-9, rtol=0)
    np.testing.assert_allclose(mf, ms, atol=1e-9, rtol=0)
