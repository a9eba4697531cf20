"""The JAX package's user functions in the port, each against its JAX twin on
the same seeded numpy inputs, on the CPU: ``GnssData`` and
``NavState.to_pose_mix`` / ``from_pose_mix`` (exact),
``state_to_camera_pose`` (1e-15), the camera's world/pixel transforms
(1e-12, f64) and its undistortion remap (1e-4 px map, 1e-3 grey levels on
320x240, f32), ``correct_block`` (1e-12), the dense
``build_normal_equations`` / ``apply_gauge`` (1e-9 of H's scale, on
tests/test_marginalization.py's 8-node world, and against the port's own
block assembly), ``OutputFiles.write_nav`` (byte for byte, but for the
last digit of the height against JAX),
``engine.config.integration_params_from_config`` at the JAX import path, and
``Tracker.track_mappoints`` on a 320x240 pair."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from test_marginalization import CFG, build_world, make_tables
from test_torch_harness import jax_compile_cache  # noqa: F401 (autouse: the run's compile cache)
from test_tracking import make_scene, render, small_camera
from test_torch_tracking import CFG as TRACK_CFG
from test_torch_tracking import _jax_table, _run
from ic_gvins_tpu.core import quaternion as jquat
from ic_gvins_tpu.core import types as jtypes
from ic_gvins_tpu.engine import config as jconfig
from ic_gvins_tpu.engine import output as joutput
from ic_gvins_tpu.factors import robust as jrobust
from ic_gvins_tpu.ins import mechanization as jmech
from ic_gvins_tpu.solver import problem as jprob
from ic_gvins_tpu.vision import camera as jcam
from ic_gvins_tpu.vision import map as jmap
from ic_gvins_tpu.vision import tracking as jtrk
from ic_gvins_tpu_torch import convert
from ic_gvins_tpu_torch.core import types as ttypes
from ic_gvins_tpu_torch.engine import config as tconfig
from ic_gvins_tpu_torch.engine import output as toutput
from ic_gvins_tpu_torch.factors import marginalization as tmarg
from ic_gvins_tpu_torch.factors import robust as trobust
from ic_gvins_tpu_torch.ins import mechanization as tmech
from ic_gvins_tpu_torch.solver import problem as tprob
from ic_gvins_tpu_torch.vision import camera as tcam
from ic_gvins_tpu_torch.vision import map as tmap
from ic_gvins_tpu_torch.vision import ransac as transac
from ic_gvins_tpu_torch.vision import tracking as ttrk

torch.set_num_threads(1)
T = lambda a: torch.tensor(np.asarray(a))  # noqa: E731


def _unit_q(rng, n):
    q = rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _rotations(rng, n):
    return np.asarray(jquat.to_matrix(jnp.asarray(_unit_q(rng, n))))


def test_gnss_data_and_pose_mix_match_jax():
    rng = np.random.default_rng(0)
    assert ttypes.GnssData._fields == jtypes.GnssData._fields
    n = 5
    fields = dict(time=rng.uniform(0, 10, n), p=rng.normal(size=(n, 3)), q=_unit_q(rng, n),
                  v=rng.normal(size=(n, 3)), bg=rng.normal(size=(n, 3)), ba=rng.normal(size=(n, 3)),
                  sodo=rng.normal(size=n), sg=np.zeros((n, 3)), sa=np.zeros((n, 3)))
    js = jtypes.NavState(**{k: jnp.asarray(v) for k, v in fields.items()})
    ts = ttypes.NavState(**{k: T(v) for k, v in fields.items()})
    (jp, jm), (tp, tm) = js.to_pose_mix(), ts.to_pose_mix()
    assert tp.shape == (n, 7) and tm.shape == (n, 10)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    jb = jtypes.NavState.from_pose_mix(jnp.asarray(fields["time"]), jp, jm)
    tb = ttypes.NavState.from_pose_mix(T(fields["time"]), tp, tm)
    for name in jtypes.NavState._fields:
        np.testing.assert_array_equal(getattr(tb, name).numpy(), np.asarray(getattr(jb, name)), err_msg=name)
        np.testing.assert_array_equal(getattr(tb, name).numpy(), fields[name], err_msg=name)


def test_state_to_camera_pose_matches_jax():
    rng = np.random.default_rng(1)
    p, q = rng.normal(0, 50, (6, 3)), _unit_q(rng, 6)
    tbc, Rbc = rng.normal(0, 0.5, 3), _rotations(rng, 1)[0]
    jt, jR = jmech.state_to_camera_pose(jnp.asarray(p), jnp.asarray(q), jnp.asarray(tbc), jnp.asarray(Rbc))
    tt, tR = tmech.state_to_camera_pose(T(p), T(q), T(tbc), T(Rbc))
    assert tt.shape == (6, 3) and tR.shape == (6, 3, 3)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=0, atol=1e-15 * 50)
    np.testing.assert_allclose(tR.numpy(), np.asarray(jR), rtol=0, atol=1e-15)


def _transform_case(name, rng):
    """(JAX args, port-side numpy args) of one transform over 40 points:
    batched rotations, the KAIST camera's distortion."""
    c = jcam.PinholeCamera.from_config(chip_smoke.KAIST_INTRINSIC, chip_smoke.KAIST_DISTORTION,
                                       [chip_smoke.W, chip_smoke.H])
    n = 40
    R, t = _rotations(rng, n), rng.normal(0, 5, (n, 3))
    pw = t + np.einsum("nij,nj->ni", R, np.c_[rng.uniform(-4, 4, (n, 2)), rng.uniform(5, 20, n)])
    px = rng.uniform([0, 0], [chip_smoke.W, chip_smoke.H], (n, 2))
    args = {"world2cam": (R, t, pw), "cam2world": (R, t, pw), "world2pixel": (c, R, t, pw),
            "reprojection_error": (c, R, t, pw, px), "pixel2unitcam": (c, px), "pixel2world": (c, R, t, px)}
    return args[name]


TRANSFORMS = ("world2cam", "cam2world", "world2pixel", "reprojection_error", "pixel2unitcam", "pixel2world")


@pytest.mark.parametrize("name", TRANSFORMS)
def test_camera_transform_matches_jax(name):
    """numpy in, numpy out and f64 tensors in, tensors out, both within
    1e-12 of the JAX function (relative to the values' scale)."""
    args = _transform_case(name, np.random.default_rng(TRANSFORMS.index(name)))
    want = np.asarray(getattr(jcam, name)(*[a if isinstance(a, jcam.PinholeCamera) else jnp.asarray(a)
                                            for a in args]))
    tc = lambda a: tcam.PinholeCamera(*a) if isinstance(a, jcam.PinholeCamera) else a  # noqa: E731
    out_np = getattr(tcam, name)(*[tc(a) for a in args])
    out_t = getattr(tcam, name)(*[a if isinstance(a, tcam.PinholeCamera) else T(a) for a in map(tc, args)])
    assert isinstance(out_np, np.ndarray) and isinstance(out_t, torch.Tensor)
    tol = 1e-12 * max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(out_np, want, rtol=0, atol=tol)
    np.testing.assert_allclose(out_t.numpy(), want, rtol=0, atol=tol)


def test_undistort_rectify_map_and_image_match_jax():
    """320x240: the map within 1e-4 px, the remapped image within 1e-3 grey
    levels (f32), taps outside the image zero exactly where JAX's are."""
    jc = small_camera()
    tc = tcam.PinholeCamera(*jc)
    jmap_ = np.asarray(jcam.undistort_rectify_map(jc))
    tmap_ = tcam.undistort_rectify_map(tc, device="cpu")
    assert tmap_.dtype == torch.float32 and tmap_.shape == (240, 320, 2)
    np.testing.assert_allclose(tmap_.numpy(), jmap_, rtol=0, atol=1e-4)
    img = np.random.default_rng(2).uniform(1, 255, (240, 320)).astype(np.float32)
    # the camera's own map, and that map shifted so that taps fall outside
    # the image on two sides
    for smap in (jmap_, jmap_ + np.float32([37.3, -21.6])):
        want = np.asarray(jcam.undistort_image(jnp.asarray(img), jnp.asarray(smap)))
        out = tcam.undistort_image(T(img), T(smap)).numpy()
        np.testing.assert_allclose(out, want, rtol=0, atol=1e-3)
        np.testing.assert_array_equal(out == 0.0, want == 0.0)
    assert (want == 0.0).sum() > 37 * 200


def test_undistort_image_inverts_distortion():
    """tests/test_vision_kernels.py's dot test on the port: a bright dot at
    a distorted location lands at its undistorted location."""
    c = tcam.PinholeCamera.from_config([120.0, 120.0, 64.0, 48.0], [-0.25, 0.08, 0.0005, 0.0003], [128, 96])
    px_dis = tcam.distort_points(c, np.array([[40.0, 30.0]]))[0]
    img = torch.zeros((96, 128), dtype=torch.float32)
    xi, yi = int(round(px_dis[0])), int(round(px_dis[1]))
    img[yi - 1: yi + 2, xi - 1: xi + 2] = 255.0
    out = tcam.undistort_image(img, tcam.undistort_rectify_map(c, device="cpu")).numpy()
    peak = np.unravel_index(np.argmax(out), out.shape)
    assert abs(peak[1] - 40.0) <= 1.5 and abs(peak[0] - 30.0) <= 1.5 and out.max() > 50.0


@pytest.mark.parametrize("scale, use", [(0.3, True), (4.0, True), (4.0, False), (0.0, True)])
def test_correct_block_matches_jax(scale, use):
    """Inside the Huber threshold, outside it, the kernel off, and a zero
    residual (the trivial branch): 1e-12."""
    rng = np.random.default_rng(3)
    r, J = scale * rng.normal(size=3) / np.sqrt(3), rng.normal(size=(3, 7))
    jr, jJ = jrobust.correct_block(jnp.asarray(r), jnp.asarray(J), use)
    tr, tJ = trobust.correct_block(T(r), T(J), use)
    assert tr.shape == (3,) and tJ.shape == (3, 7)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=1e-12)
    np.testing.assert_allclose(tJ.numpy(), np.asarray(jJ), rtol=0, atol=1e-12)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jparams(p):
    return jprob.WindowParams(*[jnp.asarray(x.numpy()) for x in p])


@pytest.fixture(scope="module")
def marg_world():
    """tests/test_marginalization.py's seed-5 world over 6 nodes: the plain
    tables at the truth, and its gradient gate's tables (2 nodes
    marginalized into a prior by the port at the truth, the absorbed
    factors off) at parameters rotated away from the prior's linearization
    point. (JAX tables and params, port tables and params.)"""
    states, summs, gnss_pos, truth = build_world(seed=5)
    tables = make_tables(states, summs, gnss_pos, 6, truth)
    ttruth = convert.window_params(_np_tree(truth), "cpu")
    ttables = convert.factor_tables(_np_tree(tables), "cpu")
    marg_tables, mask, _ = tmarg.select_marg_factors(ttables, CFG, 2, 0)
    pr = tmarg.marginalize(ttruth, marg_tables, mask, CFG)
    prior = jprob.MargPrior(H0=jnp.asarray(pr.H0.numpy()), Jte0=jnp.asarray(pr.Jte0.numpy()),
                            c0=jnp.asarray(pr.c0.numpy()), x0=_jparams(pr.x0), valid=jnp.asarray(pr.valid.numpy()))
    g = tables.gnss
    tables2 = tables._replace(
        gnss=g._replace(valid=g.valid * (jnp.arange(CFG.G) >= 2).astype(jnp.float64)),
        preint=tables.preint._replace(valid=tables.preint.valid * (tables.preint.idx0 >= 2)),
        prior=tables.prior._replace(valid=jnp.zeros(())), marg=prior)
    rng = np.random.default_rng(7)
    poses = np.array(truth.poses)
    for k in range(6):
        dq = np.asarray(jquat.from_rotvec(jnp.asarray(rng.normal(0, 0.02, 3))))
        poses[k, 3:7] = np.asarray(jquat.mul(jnp.asarray(poses[k, 3:7]), jnp.asarray(dq)))
        poses[k, :3] += rng.normal(0, 0.05, 3)
    p2 = truth._replace(poses=jnp.asarray(poses))
    out = {}
    for case, (params, tabs) in (("plain", (truth, tables)), ("prior", (p2, tables2))):
        out[case] = ((params, tabs), (convert.window_params(_np_tree(params), "cpu"),
                                      convert.factor_tables(_np_tree(tabs), "cpu")))
    return out


_jax_dense = jax.jit(lambda p, t: jprob.build_normal_equations(p, t, CFG))


@pytest.mark.parametrize("case", ["plain", "prior"])
def test_build_normal_equations_matches_jax(marg_world, case):
    """H, b, act and the gauged system against JAX: H within 1e-9 of its
    scale; each entry of b within 1e-9 of its Cauchy-Schwarz scale
    sqrt(H_ii) |r| (|r|^2 = twice the total cost), the size of the f64
    rounding of the sums of J_i r over whitened factors as stiff as the
    preintegration's (H reaches ~2e11 here)."""
    (params, tables), (tparams, ttables) = marg_world[case]
    H, b, act = (np.asarray(x) for x in _jax_dense(params, tables))
    tH, tb, tact = tprob.build_normal_equations(tparams, ttables, CFG)
    assert tH.shape == (CFG.D, CFG.D) and tb.shape == (CFG.D,)
    scale = max(float(np.abs(H).max()), 1.0)
    btol = 1e-9 * (np.sqrt(np.diag(H) * 2.0 * float(tprob.total_cost(tparams, ttables, CFG))) + 1.0)
    np.testing.assert_allclose(tH.numpy(), H, rtol=0, atol=1e-9 * scale)
    assert (np.abs(tb.numpy() - b) <= btol).all(), np.abs(tb.numpy() - b).max()
    np.testing.assert_array_equal(tact.numpy(), act)
    jHg, jbg = (np.asarray(x) for x in jprob.apply_gauge(jnp.asarray(H), jnp.asarray(b), jnp.asarray(act)))
    tHg, tbg = tprob.apply_gauge(tH, tb, tact)
    np.testing.assert_allclose(tHg.numpy(), jHg, rtol=0, atol=1e-9 * scale)
    assert (np.abs(tbg.numpy() - jbg) <= btol).all()
    off = tact.numpy() == 0
    assert off.any()
    np.testing.assert_array_equal(tHg.numpy()[off][:, off], np.eye(int(off.sum())))
    assert not tHg.numpy()[off][:, ~off].any() and not tbg.numpy()[off].any()


@pytest.mark.parametrize("seed", [0, 1])
def test_build_normal_equations_equals_blocks(seed):
    """The dense H equals the port's Hss / Hsl / hll block by block (1e-9 of
    its scale) and b equals the blocks' b, on chip_smoke.np_problem's window
    with every factor type, extrinsic and td active, parameters perturbed;
    the landmark-landmark block is diagonal."""
    cfg = tprob.WindowConfig(N=6, L=32, G=8, R=128, with_earth=False)
    params, tables = chip_smoke.np_problem(cfg, seed)
    rng = np.random.default_rng(seed + 3)
    params = params._replace(poses=params.poses + np.c_[rng.normal(0, 0.03, (cfg.N, 3)), np.zeros((cfg.N, 4))],
                             invdepths=params.invdepths + rng.normal(0, 0.005, cfg.L))
    tables = tables._replace(ext_active=np.ones(()), td_active=np.ones(()))
    tparams, ttables = convert.window_params(params, "cpu"), convert.factor_tables(tables, "cpu")
    H, b, act = tprob.build_normal_equations(tparams, ttables, cfg)
    Hss, Hsl, hll, b2, act2 = tprob.build_normal_blocks(tparams, ttables, cfg)
    Ds = cfg.lm_off
    H = H.numpy()
    scale = max(np.abs(H).max(), 1.0)
    np.testing.assert_allclose(Hss.numpy(), H[:Ds, :Ds], rtol=0, atol=1e-9 * scale)
    np.testing.assert_allclose(Hsl.numpy(), H[:Ds, Ds:], rtol=0, atol=1e-9 * scale)
    np.testing.assert_allclose(H[Ds:, :Ds], H[:Ds, Ds:].T, rtol=0, atol=0)
    np.testing.assert_allclose(hll.numpy(), np.diag(H)[Ds:], rtol=0, atol=1e-9 * scale)
    assert not (H[Ds:, Ds:] - np.diag(np.diag(H)[Ds:])).any()
    np.testing.assert_allclose(b2.numpy(), b.numpy(), rtol=0, atol=1e-9 * max(np.abs(b.numpy()).max(), 1.0))
    np.testing.assert_array_equal(act2.numpy(), act.numpy())
    assert np.abs(Hsl.numpy()).max() > 0 and np.abs(H[cfg.ext_off:Ds]).max() > 0


def test_write_nav_bytes_equal_chunk_and_jax(tmp_path):
    """400 samples through the port's write_nav one at a time, through one
    write_nav_chunk, and through the JAX write_nav (1 in 10 written): the
    port's two paths byte for byte; against JAX, IMU_ERR.bin and
    trajectory.csv byte for byte, gvins.nav byte for byte but for the
    height's ninth decimal. The height leaves an ECEF point of norm 6.4e6 m
    (one ulp 9.3e-10 m) through the JAX package's ecef2blh loop, which XLA
    compiles with contracted (fused) arithmetic; numpy rounds each step, so
    the last digit moves (by at most 2 here)."""
    rng = np.random.default_rng(4)
    n = 400
    origin = np.array([np.deg2rad(30.5), np.deg2rad(114.3), 40.0])
    times = 100.0 + 0.005 * np.arange(n)
    p, q, v = rng.normal(0, 30, (n, 3)), _unit_q(rng, n), rng.normal(0, 3, (n, 3))
    bg, ba = rng.normal(0, 1e-3, 3), rng.normal(0, 1e-2, 3)
    outs = {k: tmp_path / k for k in ("jax", "one", "chunk")}
    writers = {"jax": joutput.OutputFiles(str(outs["jax"])), "one": toutput.OutputFiles(str(outs["one"])),
               "chunk": toutput.OutputFiles(str(outs["chunk"]))}
    for i in range(n):
        writers["jax"].write_nav(origin, float(times[i]), p[i], q[i], v[i], bg, ba, sodo=0.25)
        writers["one"].write_nav(origin, float(times[i]), p[i], q[i], v[i], bg, ba, sodo=0.25)
    writers["chunk"].write_nav_chunk(origin, times, p, q, v, bg, ba, sodo=0.25)
    for w in writers.values():
        w.close()
    for name in ("gvins.nav", "IMU_ERR.bin", "trajectory.csv"):
        assert (outs["one"] / name).read_bytes() == (outs["chunk"] / name).read_bytes(), name
    for name in ("IMU_ERR.bin", "trajectory.csv"):
        assert (outs["one"] / name).read_bytes() == (outs["jax"] / name).read_bytes(), name
    jl, tl = ((outs[k] / "gvins.nav").read_text().splitlines() for k in ("jax", "one"))
    assert len(jl) == len(tl) == 40
    for a, b in zip(jl, tl):
        ja, tb = a.split(), b.split()
        assert len(ja) == len(tb) == 11 and ja[:4] + ja[5:] == tb[:4] + tb[5:], (a, b)
        assert abs(float(ja[4]) - float(tb[4])) <= 2.5e-9 and len(ja[4]) == len(tb[4]), (a, b)


@pytest.mark.parametrize("odometer", [False, True])
def test_integration_params_from_config_at_jax_path(odometer):
    raw = dict(imumodel=dict(arw=0.2, vrw=0.3, gbstd=50.0, abstd=80.0, corrtime=2.0))
    if odometer:
        raw.update(isuseodo=True, odometer=dict(std=[0.02, 0.5, 0.5], srw=1000.0, abv=[0.0, 0.01, 0.0],
                                                lodo=[0.1, 0.0, -0.2]))
    jp = jconfig.integration_params_from_config(jconfig.parse_config(raw))
    tp = tconfig.integration_params_from_config(tconfig.parse_config(raw))
    assert float(tp.gravity) == tconfig.NORMAL_GRAVITY == 9.80
    for name in jtypes.IntegrationParams._fields:
        np.testing.assert_array_equal(getattr(tp, name).numpy(), np.asarray(getattr(jp, name)), err_msg=name)


def test_track_mappoints_matches_jax():
    """Both trackers through 13 frames of test_tracking.py's 320x240
    sequence (the port's RANSAC draw set to the JAX table), then the 14th
    frame through ``track_mappoints`` alone: the same return, tracked counts
    within 2 (ROADMAP P1), the tracked points of landmarks with the same
    observation in the previous frame within 1e-3 px (median), the landmark
    parallax within 1e-2 px."""
    camera = small_camera()
    pts = make_scene()
    poses = [(np.eye(3), np.array([0.15 * k, 0.0, 0.0])) for k in range(14)]
    images = [render(camera, pts, R, t) for R, t in poses]
    jvmap = jmap.VisualMap(8)
    jt = jtrk.Tracker(camera, jvmap, jconfig.parse_config(TRACK_CFG), F_MAX=256)
    tvmap = tmap.VisualMap(8)
    tt = ttrk.Tracker(tcam.PinholeCamera(*camera), tvmap, tconfig.parse_config(TRACK_CFG), F_MAX=256, device="cpu")
    mp = pytest.MonkeyPatch()
    mp.setattr(transac, "_draw_samples", lambda valid, num_hyp, generator:
               torch.tensor(np.asarray(_jax_table(jnp.asarray(valid.numpy())))))
    try:
        _run(jt, jvmap, jmap.VFrame, images[:13], poses[:13])
        _run(tt, tvmap, tmap.VFrame, images[:13], poses[:13])
        assert not jt.initializing and not tt.initializing
        got = {}
        for name, trk, frame_cls in (("jax", jt, jmap.VFrame), ("port", tt, tmap.VFrame)):
            trk._track_normal = lambda trk=trk, name=name: got.setdefault(name, trk.track_mappoints())
            frame = frame_cls(stamp=1.3)
            frame.R, frame.t = poses[13][0], poses[13][1].copy()
            trk.track(frame, images[13])
    finally:
        mp.undo()
    assert got["jax"] is got["port"] is True
    jl, tl = jt.tracked_mappoints, tt.tracked_mappoints
    assert len(tl) >= 20 and abs(len(jl) - len(tl)) <= 2, (len(jl), len(tl))
    # pair the tracked landmarks by their observation in the previous frame
    jprev = np.stack([jt.frame_pre.features[lm.id].dis for lm in jl])
    d = []
    for lm in tl:
        k = int(np.argmin(np.linalg.norm(jprev - tt.frame_pre.features[lm.id].dis, axis=1)))
        if np.linalg.norm(jprev[k] - tt.frame_pre.features[lm.id].dis) < 1e-3:
            d.append(np.linalg.norm(jt.frame_cur.features[jl[k].id].dis - tt.frame_cur.features[lm.id].dis))
    assert len(d) >= len(tl) - 2 and np.median(d) < 1e-3, (len(d), len(tl), np.median(d))
    assert abs(jt.parallax_map - tt.parallax_map) < 1e-2 and jt.parallax_map_counts == tt.parallax_map_counts
