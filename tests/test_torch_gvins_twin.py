"""The port's GNSS-visual-inertial replay (``GvinsModel``) on the CPU, against
the JAX package's ``GvinsModel`` and against the ground truth, on
tests/test_torch_gvins.py's world (``world()``: the configuration of
tests/test_gvins_e2e.py, its drive cut to 14 s). The JAX solve runs in its
f64 mode (``precise=True``) and the port's RANSAC draws the JAX package's
hypothesis table, so the two replays see the same frontend decisions. The
JAX replay runs in a child process with the CPU client's async dispatch off,
which makes it the same under any load of the machine (ROADMAP R3). Also:
the reprojection-table packing on every episode of the replay and the solve
tiers on its final window.

These twins wait on a JAX child, so they live in a file of few tests: the
test queue takes files by their count of tests, most first, and this one
then starts after tests/test_gvins_long_e2e.py
(test_torch_harness.py::test_child_modules_queue_after_the_long_replay).

Tolerances, each against the JAX twin:
- the state after every frame, node times, keyframe episodes and tiers,
  statistics.txt rows with their stamps and frame ids, the packed
  reprojection rows and their count on the same map: equal;
- features of a keyframe and landmarks in the final map: within 2 (the JAX
  CPU LK culls tracks at its 48x128 gather block, the port does not;
  ROADMAP P1; observed: one landmark);
- positions 5e-5 m, attitudes (quaternion components) 2e-5, velocities 2e-5
  m/s: that landmark moves the window's solution (observed 8.5e-6 m,
  2.9e-6, 3.6e-6 m/s).
"""

import os
import pickle
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_gins import _precise_solve_jit
from test_torch_gvins import RATE, _state, raw_cfg, spy, world
from test_torch_harness import jax_child, jax_result, kill_if_running, module_reads
from test_torch_harness import jax_compile_cache  # noqa: F401 (autouse: the run's compile cache)
from test_torch_tracking import _jax_table
from ic_gvins_tpu.engine import estimator as jest
from ic_gvins_tpu.engine.config import parse_config as jparse
from ic_gvins_tpu.models.gvins import GvinsModel as JGvins
from ic_gvins_tpu_torch.engine.config import parse_config as tparse
from ic_gvins_tpu_torch.models.gvins import GvinsModel as TGvins
from ic_gvins_tpu_torch.solver import lm as tlm
from ic_gvins_tpu_torch.solver import problem as tprob
from ic_gvins_tpu_torch.vision import ransac as transac

torch.set_num_threads(1)
TWIN = dict(pos=5e-5, att=2e-5, vel=2e-5, features=2)
GVINS_CHILD_LIMIT = 420   # s: ~3x the JAX child's wall alone on an 8-core CPU (140.1 s)


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
    module, so that it runs while the port's replay does: (child, its
    output directory, pickle path), or None where no test of the module
    reads the replays. Killed at the module's end if still running."""
    if not module_reads(request, "replays"):
        yield None
        return
    outdir = str(tmp_path_factory.mktemp("jax_gvins"))
    out_path = os.path.join(outdir, "jax_replay.pkl")
    child = jax_child("test_torch_gvins_twin:jax_replay", outdir, out_path)
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
            kids.append((jax_child("test_torch_gvins_twin:jax_replay", str(d), str(d / "out.pkl"),
                                   dispatch=dispatch), str(d / "out.pkl")))
        return [jax_result(child, path, timeout=1200)[1] for child, path in kids]

    alone = runs("alone", "sync", 1)[0]
    diffs = {}
    for dispatch in ("sync", "async"):
        diffs[dispatch] = [float(np.abs(t[:, 1:4] - alone[:, 1:4]).max()) if t.shape == alone.shape else float("inf")
                           for t in runs(dispatch, dispatch, 4)]
    print(f"\nfour copies at once against the run alone, largest position difference (m): {diffs}")
    assert diffs["sync"] == [0.0] * 4


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
