"""The port's GvinsModel with time-delay (td) estimation on, against the JAX
package's, on the drifted-clock world of tests/test_td_estimation.py: its
images are exposed 30 ms after their stamps and the estimator starts at td
= 0, so td walks through the 20 ms-per-episode adoption gate.

Both replays run that test's own fixture body (``td_run``), its
GvinsModel given an output directory and ``chip_smoke.EstimationLog`` (the
JAX tests' hooks wrapped on the instance): the JAX ones in child processes
with the CPU client's async dispatch off and its solve in f64 (as
tests/test_torch_gvins_twin.py runs it), the port's here on the same numpy
world, its RANSAC drawing the JAX package's hypothesis table. Two cases:
``td``, the test's configuration verbatim (extrinsic estimation off), and
``td+extrinsic``, the same world with extrinsic estimation on as well (the
stability world's setting), so that the extrinsic gate and extrinsic.txt
are held too (on this planar 12 s drive the extrinsic estimate swings by
metres and the gate refuses it every time).

Cut: the drive's turn is 6 s (a 12 s drive; 30 s in the JAX test), the
shortest whole-second turn at which the JAX replay adopts td at least 3
times (4 adoptions; a 5 s turn gives 2). The full horizon runs on the card
in chip_smoke.py phase 11. The two JAX replays run one after the other in
one child process started with the module (``jax_td_replays``), beside the
world and yaw tests and the port's two replays; the second case takes the
programs the first compiled. Alone on an 8-core CPU that child took 155.6 s
and 365.2 s of CPU time, against 145.0 s and 526.7 s for two children at
once without the compile cache, with the same results bit for bit.

Tolerances, each against the JAX twin:
- the state and node count after every frame, the frames, keyframe
  episodes and marginalizations, every adopt/refuse decision of the td and
  extrinsic gates, the solver tiers, each episode's GNSS fixes in the
  window and reprojection rows, and the episodes where
  ``check_time_consistency`` finds a violation: equal;
- td after every episode within 1e-6 s;
- node times within 1e-6 s: a keyframe node sits at its frame's stamp plus
  the td adopted then, so node times carry td's difference (observed
  2.5e-8 s), not equal as in tests/test_torch_gvins_twin.py, where td is fixed
  (td itself: observed 2.5e-8 s with extrinsic estimation off, 4.3e-7 s
  with it on, where the unobservable extrinsic columns amplify rounding);
- positions 5e-5 m, attitudes (quaternion components) 2e-5, velocities 2e-5
  m/s, as tests/test_torch_gvins_twin.py (ROADMAP P1; observed 2.0e-7 m,
  2.4e-8, 1.3e-7 m/s);
- the adopted extrinsic within 1e-6; extrinsic.txt rows: time and td within
  1e-6, the estimate's translation (m) and Euler angles (degrees) within
  1e-3 of their size (observed 2.4e-4): the gate refuses every one of these
  estimates, which swing between 0.1 and 670 m on this planar 12 s drive,
  where the extrinsic is not observable and the window's solve amplifies the
  two packages' rounding along it.
Also: chip_smoke.td_world against the JAX test's world (the streams within
1e-9, as tests/test_torch_gins.py holds the drive; three frames within
1e-9 gray, as tests/test_torch_gvins.py holds its renderer, observed
2.6e-11: the truths agree within 1e-9 m, and the JAX renderer projects and
distorts with XLA-compiled jnp ops, the port with numpy; the configuration
dict equal), and the twin of
tests/test_gvins_e2e.py::test_dual_antenna_yaw_through_gvins.
"""

import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import test_td_estimation as tde
from gins_data import make_gins_dataset
from test_torch_gins import _precise_solve_jit
from test_torch_harness import jax_child, jax_result, kill_if_running, module_reads
from test_torch_harness import jax_compile_cache  # noqa: F401 (autouse: the run's compile cache)
from test_torch_scripts import _close_world
from test_torch_tracking import _jax_table
from ic_gvins_tpu.engine import estimator as jest
from ic_gvins_tpu.models.gvins import GvinsModel as JGvins
from ic_gvins_tpu_torch.engine.config import parse_config as tparse
from ic_gvins_tpu_torch.models.gvins import GvinsModel as TGvins
from ic_gvins_tpu_torch.vision import ransac as transac

torch.set_num_threads(1)
TURN = 6.0
CASES = {"td": {}, "td+extrinsic": {"optimize_estimate_extrinsic": True}}
TWIN = dict(pos=5e-5, att=2e-5, vel=2e-5, td=1e-6, ext=1e-6, ext_estimate=1e-3)
TD_CHILD_LIMIT = 460   # s: ~3x the JAX child's wall alone on an 8-core CPU (153.5 s, both cases)


class Recorder:
    """Stands in for GvinsModel in a JAX test's fixture body: keeps what the
    body hands to run (the methods the bodies wrap are there to wrap)."""

    def __init__(self, cfg, outdir=None):
        self.cfg, self.td_b_c, self.inputs = cfg, 0.0, None
        self._process_frame = self._optimize_visual = self._marginalize_visual_impl = None
        Recorder.last = self

    def _update_from_optimizer(self, *args):
        return None

    def run(self, imu, gnss, frame_times, image_provider):
        self.inputs = imu, gnss, frame_times, image_provider
        return np.zeros((0, 8))


def patched_fixture(mp, module, body, attrs, model_factory, overrides=None):
    """Runs ``body``, a JAX test's fixture body, with ``attrs`` set on its
    test module ``module``, ``overrides`` applied to the configuration dict
    it parses and its GvinsModel replaced by ``model_factory``; returns the
    raw dicts it parsed and what the body returned."""
    raws, real_parse = [], module.parse_config

    def parse(raw):
        raws.append({**raw, **(overrides or {})})
        return real_parse(raws[-1])

    for name, value in {**attrs, "parse_config": parse, "GvinsModel": model_factory}.items():
        mp.setattr(module, name, value)
    return raws, body()


def _td_fixture(mp, turn, overrides, model_factory):
    """tests/test_td_estimation.py's fixture body with its drive's turn set
    to ``turn`` (``patched_fixture``)."""
    return patched_fixture(mp, tde, tde.td_run.__wrapped__,
                           {"make_gins_dataset": lambda turn_duration: make_gins_dataset(turn_duration=turn)},
                           model_factory, overrides)


def td_test_world(turn=TURN, overrides=None):
    """The JAX test's world and configuration at ``turn``: (raw config dict,
    imu, gnss, frame_times, image provider)."""
    mp = pytest.MonkeyPatch()
    try:
        raws, _ = _td_fixture(mp, turn, overrides, Recorder)
    finally:
        mp.undo()
    return (raws[-1], *Recorder.last.inputs)


def replay_summary(model, traj, log, truth=None):
    """What the twin tests hold of one replay of either package's
    GvinsModel with an ``EstimationLog``."""
    est = model.est
    return dict(state=model.state, td_b_c=float(model.td_b_c), t_b_c=np.array(model.pose_b_c_t),
                R_b_c=np.array(model.pose_b_c_R), n_nodes=est.n_nodes, times=np.array(est.times[:est.n_nodes]),
                mixes=np.array(est.mixes[:est.n_nodes]), tier_counts=dict(model.tier_counts),
                traj=np.asarray(traj), states=log.states, tds=log.tds, decisions=log.decisions,
                counts=log.counts, failures=log.failures, episodes=log.episodes, truth=truth)


def jax_td_replay(outdir, case):
    """The JAX test's fixture body at TURN for ``case`` (its solve in f64),
    the model with output files into outdir and an EstimationLog: its
    summary."""
    logs = []

    def make(cfg):
        model = JGvins(cfg, outdir=outdir)
        logs.append(chip_smoke.EstimationLog(model))
        return model

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jest, "_solve_jit", _precise_solve_jit)
        _, (model, traj, _) = _td_fixture(mp, TURN, CASES[case], make)
    finally:
        mp.undo()
    return replay_summary(model, traj, logs[0])


def jax_td_replays(out_path, *outdirs):
    """``jax_td_replay`` of each case of CASES, its output files into the
    matching one of ``outdirs``, one after the other in this process (the
    later case takes the programs the first compiled); pickles {case:
    summary} to out_path."""
    with open(out_path, "wb") as f:
        pickle.dump({case: jax_td_replay(d, case) for case, d in zip(CASES, outdirs)}, f)


def port_td_replay(outdir, raw, imu, gnss, frame_times, images):
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(transac, "_draw_samples", lambda valid, num_hyp, generator:
                   torch.tensor(np.asarray(_jax_table(jnp.asarray(valid.numpy())))))
        model = TGvins(tparse(raw), outdir=outdir, device="cpu")
        log = chip_smoke.EstimationLog(model)
        traj = model.run(imu, gnss, frame_times, lambda k: images[k])
    finally:
        mp.undo()
    return replay_summary(model, traj, log)


def test_chip_smoke_td_world_matches_jax_test():
    """chip_smoke.td_world (jax-free) gives the JAX test's world at its own
    30 s turn: the streams within 1e-9 (GNSS heights 1e-8 m, as
    tests/test_torch_gins.py holds the drive), the frame stamps equal, three
    frames (the first, one in the turn, the last) within 1e-9 gray (observed
    2.6e-11: the renderers' projection arithmetic differs in the last ulp), and its
    configuration dict equal to the test's."""
    from ic_gvins_tpu_torch.core import rotation_np
    from ic_gvins_tpu_torch.vision import camera as tcam

    raw, imu, gnss, frame_times, provider = td_test_world(chip_smoke.TD_TURN)
    p_imu, p_gnss, truth, p_times, frame = chip_smoke.td_world(tcam, rotation_np)
    _close_world((p_imu, p_gnss), (imu, gnss))
    np.testing.assert_array_equal(p_times, frame_times)
    for k in (0, 200, len(frame_times) - 1):
        np.testing.assert_allclose(frame(k), provider(k), atol=1e-9, rtol=0, err_msg=f"frame {k}")
    assert chip_smoke.gvins_raw(truth, chip_smoke.TD_RAW, chip_smoke.SMALL_CAMERA) == raw
    assert chip_smoke.TD_TRUE == tde.TD_TRUE


def test_dual_antenna_yaw_through_gvins():
    """The port's twin of tests/test_gvins_e2e.py's test of the same name:
    GvinsModel.run forwards yaw/isyawvalid into its GNSS events, so the
    shared initialization takes the dual-antenna heading; a replay with no
    frames runs just the INITIALIZING stage and on (its configuration:
    that test's; its drive cut to 8 s, as the heading is taken at the
    first fixes)."""
    imu, gnss, truth = make_gins_dataset(turn_duration=2.0)
    raw = chip_smoke.gvins_raw(truth, dict(
        initlength=3, imudatarate=200, iswithearth=False,
        imumodel=dict(arw=0.1, vrw=0.1, gbstd=400.0, abstd=400.0, corrtime=1.0), gnssthreshold=20,
        optimize_windows_size=8, node_slots=20, landmark_slots=64, gnss_slots=20, reproj_slots=256),
        chip_smoke.SMALL_CAMERA)
    g = {k: np.array(v, copy=True) for k, v in gnss.items()}
    n = len(g["time"])
    yaw_injected = 0.17
    g["yaw"] = np.full(n, yaw_injected)
    g["isyawvalid"] = np.ones(n, bool)
    model = TGvins(tparse(raw), device="cpu")
    model.run(imu, g, np.zeros(0), lambda k: None)
    assert model.est is not None, "did not initialize"
    assert abs(model._initatt[2] - yaw_injected) < 1e-12


@pytest.fixture(scope="module", autouse=True)
def jax_twins(request, jax_compile_cache, tmp_path_factory):
    """``jax_td_replays`` in a child process started with the module, so
    that the JAX replays run while the tests before the twin test run:
    (child, pickle path, {case: outdir}), or None where no test of the
    module reads them. Killed at the module's end if still running."""
    if not module_reads(request, "twins"):
        yield None
        return
    dirs = {case: str(tmp_path_factory.mktemp(f"jax_{case}")) for case in CASES}
    out_path = os.path.join(dirs["td"], "jax_td.pkl")
    child = jax_child("test_torch_td:jax_td_replays", out_path, *dirs.values())
    yield child, out_path, dirs
    kill_if_running(child)


@pytest.fixture(scope="module")
def twins(jax_twins, tmp_path_factory):
    """Both cases: the port's replays here while the JAX child runs.
    Returns {case: (jax summary, port summary, jax outdir, port outdir)}."""
    out = {}
    try:
        for case, overrides in CASES.items():
            raw, imu, gnss, frame_times, provider = td_test_world(TURN, overrides)
            images = [provider(k) for k in range(len(frame_times))]
            d = str(tmp_path_factory.mktemp(f"port_{case}"))
            out[case] = port_td_replay(d, raw, imu, gnss, frame_times, images), d
    finally:
        child, out_path, dirs = jax_twins
        jax_out = jax_result(child, out_path, timeout=TD_CHILD_LIMIT)
    return {case: (jax_out[case], out[case][0], dirs[case], out[case][1]) for case in CASES}


def _extrinsic_rows(outdir):
    path = os.path.join(outdir, "extrinsic.txt")
    return np.loadtxt(path, ndmin=2) if os.path.getsize(path) else np.zeros((0, 8))


@pytest.mark.parametrize("case", list(CASES))
def test_td_replay_matches_jax_twin(twins, case):
    j, t, jdir, tdir = twins[case]
    d = lambda a, b: float(np.abs(np.asarray(a) - np.asarray(b)).max())  # noqa: E731
    if t["traj"].shape == j["traj"].shape:
        print(f"\n{case}: {j['counts']}, td adoptions {[x[0] for x in j['decisions']].count(True)}; largest "
              f"differences: td {d(t['tds'], j['tds']):.3g} s, node times {d(t['traj'][:, 0], j['traj'][:, 0]):.3g} s, "
              f"positions {d(t['traj'][:, 1:4], j['traj'][:, 1:4]):.3g} m, attitudes "
              f"{d(t['traj'][:, 4:8], j['traj'][:, 4:8]):.3g}, velocities {d(t['mixes'][:, :3], j['mixes'][:, :3]):.3g}")
    assert t["state"] == j["state"] == "TRACKING_NORMAL"
    assert t["states"] == j["states"]                                   # after every frame
    assert t["counts"] == j["counts"] and t["tier_counts"] == j["tier_counts"]
    assert t["decisions"] == j["decisions"]                             # every gate decision
    adopted = [x[0] for x in j["decisions"]].count(True)
    assert adopted >= 3, j["decisions"]
    if case == "td+extrinsic":     # the gate runs; on this drive it refuses every estimate
        assert sum(x[1] is not None for x in j["decisions"]) >= 3, j["decisions"]
    assert [e for e, *_ in t["failures"]] == [e for e, *_ in j["failures"]]
    # every episode's frame, GNSS fixes in the window and reprojection rows
    assert [(f, g, r) for f, _, g, r in t["episodes"]] == [(f, g, r) for f, _, g, r in j["episodes"]]
    np.testing.assert_allclose([e[1] for e in t["episodes"]], [e[1] for e in j["episodes"]], atol=TWIN["td"], rtol=0)
    np.testing.assert_allclose(t["tds"], j["tds"], atol=TWIN["td"], rtol=0)
    assert t["traj"].shape == j["traj"].shape
    np.testing.assert_allclose(t["traj"][:, 0], j["traj"][:, 0], atol=TWIN["td"], rtol=0)   # node times
    np.testing.assert_allclose(t["traj"][:, 1:4], j["traj"][:, 1:4], atol=TWIN["pos"], rtol=0)
    np.testing.assert_allclose(t["traj"][:, 4:8], j["traj"][:, 4:8], atol=TWIN["att"], rtol=0)
    assert t["n_nodes"] == j["n_nodes"]
    np.testing.assert_allclose(t["times"], j["times"], atol=TWIN["td"], rtol=0)
    np.testing.assert_allclose(t["mixes"][:, :3], j["mixes"][:, :3], atol=TWIN["vel"], rtol=0)
    assert abs(t["td_b_c"] - j["td_b_c"]) < TWIN["td"]
    np.testing.assert_allclose(t["t_b_c"], j["t_b_c"], atol=TWIN["ext"], rtol=0)
    np.testing.assert_allclose(t["R_b_c"], j["R_b_c"], atol=TWIN["ext"], rtol=0)
    je, te = _extrinsic_rows(jdir), _extrinsic_rows(tdir)
    assert te.shape == je.shape and (len(te) > 0) == (case == "td+extrinsic"), (te.shape, je.shape)
    np.testing.assert_allclose(te[:, [0, 7]], je[:, [0, 7]], atol=TWIN["ext"], rtol=0)     # time, td
    np.testing.assert_allclose(te[:, 1:7], je[:, 1:7], atol=TWIN["ext"], rtol=TWIN["ext_estimate"])
