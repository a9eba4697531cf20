"""The port's parallel/mesh.py on the CPU, over a mesh of eight CPU devices
(``make_mesh(["cpu"] * 8)``), at tests/test_parallel.py's shapes: 16
distinct problems or worlds, two a shard, so every shard runs a batch.

Against the port's own single call, element by element: the batch runs the
same f64 ops over a leading axis, so the two differ by rounding only, held
within 1e-9 (poses, costs, INS summaries and states; of the scale of H0 and
Jte0 for the prior). The solve takes test_parallel.py's 4 iterations: with
20, rounding the vectorized transcendentals reach differently at other
batch sizes grows along the flat directions of these 3-4-node windows to
~3e-8 in the poses while the costs agree to 1e-10 relative. The frontend
frame (f32, the kernels' plain versions) must give equal masks and points.

Against the JAX forms, two elements each (the JAX single call, jitted once):
the solve at test_parallel.py's tolerances (poses 2e-4, cost rtol 5e-3: the
JAX solve seeds in f32, ROADMAP P4), the marginalization at
test_torch_marginalization.py's, the INS at test_torch_ins.py's and
test_torch_preint.py's, the frontend with the JAX RANSAC table patched in
and at most 2 features a world whose flags differ (ROADMAP P1).

Also: the plain kernel versions' world axis against unbatched calls, the
batched LM's per-problem stop, make_mesh without CUDA, and chip_smoke.py's
copy of ``__graft_entry__._np_problem`` leaf for leaf."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
import chip_smoke
from test_torch_harness import jax_compile_cache  # noqa: F401 (autouse: the run's compile cache)
from test_torch_preint import _check as check_summary
from test_torch_tracking import _jax_table
from ic_gvins_tpu.core import types as jtypes
from ic_gvins_tpu.factors import marginalization as jmarg
from ic_gvins_tpu.ins import mechanization as jmech
from ic_gvins_tpu.ins import preintegration as jpre
from ic_gvins_tpu.parallel import mesh as jmesh
from ic_gvins_tpu.solver import lm as jlm
from ic_gvins_tpu.solver import problem as jprob
from ic_gvins_tpu_torch import convert
from ic_gvins_tpu_torch.core import types as ttypes
from ic_gvins_tpu_torch.engine.host import fetch
from ic_gvins_tpu_torch.factors import marginalization as tmarg
from ic_gvins_tpu_torch.ins import mechanization as tmech
from ic_gvins_tpu_torch.ins import preintegration as tpre
from ic_gvins_tpu_torch.ops import clahe as kclahe
from ic_gvins_tpu_torch.ops import lk as klk
from ic_gvins_tpu_torch.ops import subpix as ksubpix
from ic_gvins_tpu_torch.parallel import mesh as pmesh
from ic_gvins_tpu_torch.solver import lm as tlm
from ic_gvins_tpu_torch.solver import problem as tprob
from ic_gvins_tpu_torch.vision import pyramid as tpyr
from ic_gvins_tpu_torch.vision import ransac as transac

torch.set_num_threads(1)
MESH = ["cpu"] * 8
B = 16
CFG = tprob.WindowConfig(N=4, L=16, G=4, R=32, with_earth=False)
JCFG = jprob.WindowConfig(*CFG)
ITERS = 4
H, W, F = 120, 160, 64
FRAME_KW = dict(levels=3, block=(2, 2, 4), min_distance=5)
S = 64
CHECKED = (0, B - 1)   # the elements held against the JAX forms


def element(tree, k):
    return pmesh.tree_map(lambda a: a[k], tree)


def max_diff(a, b):
    return float((a - b).abs().max())


def problems(seed):
    """B distinct window problems (numpy trees), and the port's trees."""
    probs = [ge._np_problem(JCFG, seed=seed + k) for k in range(B)]
    port = [(convert.window_params(p, "cpu"), convert.factor_tables(t, "cpu")) for p, t in probs]
    return probs, port


@functools.lru_cache(maxsize=None)
def _jax_solve():
    return jax.jit(lambda p, t: jlm.solve_two_pass(p, t, JCFG, ITERS)[0])


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


# ---------------------------------------------------------------------------
# the four forms
# ---------------------------------------------------------------------------

def test_sharded_two_pass_matches_single_and_jax():
    probs, port = problems(0)
    fn, place = pmesh.sharded_two_pass(pmesh.make_mesh(MESH), CFG, ITERS)
    shards = fn(place(pmesh.stack([p for p, _ in port])), place(pmesh.stack([t for _, t in port])))
    assert len(shards) == len(MESH) and all(s[0].poses.shape[0] == B // len(MESH) for s in shards)
    out_params, out_tables = pmesh.gather(shards)
    for k in range(B):
        ref_p, ref_t, _ = tlm.solve_two_pass(*port[k], CFG, ITERS)
        assert max_diff(out_params.poses[k], ref_p.poses) <= 1e-9
        assert max_diff(out_params.mixes[k], ref_p.mixes) <= 1e-9
        assert max_diff(out_params.invdepths[k], ref_p.invdepths) <= 1e-9
        got = tprob.total_cost(element(out_params, k), element(out_tables, k), CFG)
        np.testing.assert_allclose(float(got), float(tprob.total_cost(ref_p, ref_t, CFG)), rtol=1e-9)
    for k in CHECKED:
        jp, jt = _jax(probs[k][0]), _jax(probs[k][1])
        ref = _jax_solve()(jp, jt)
        np.testing.assert_allclose(out_params.poses[k].numpy(), np.asarray(ref.poses), atol=2e-4)
        c_ref = float(jprob.total_cost(ref, jt, JCFG))
        c_port = float(jprob.total_cost(jprob.WindowParams(*[jnp.asarray(a.numpy()) for a in element(out_params, k)]),
                                        jt, JCFG))
        np.testing.assert_allclose(c_port, c_ref, rtol=5e-3, atol=1e-9)


def test_sharded_marg_step_matches_single_and_jax():
    probs, port = problems(21)
    fn, place = pmesh.sharded_marg_step(pmesh.make_mesh(MESH), CFG)
    prior = pmesh.gather(fn(place(pmesh.stack([p for p, _ in port])), place(pmesh.stack([t for _, t in port]))))

    def one_port(params, tables):
        mt, mask, _ = tmarg.select_marg_factors(tables, CFG, 1, 0)
        return tmarg.shift_prior(tmarg.marginalize(params, mt, mask, CFG), CFG, 1)

    @jax.jit
    def one_jax(params, tables):
        mt, mask, _ = jmarg.select_marg_factors(tables, JCFG, 1, 0)
        return jmarg.shift_prior(jmarg.marginalize(params, mt, mask, JCFG), JCFG, 1)

    for k in range(B):
        ref = one_port(*port[k])
        scale = max(float(ref.H0.abs().max()), 1.0)
        assert max_diff(prior.H0[k], ref.H0) <= 1e-9 * scale
        assert max_diff(prior.Jte0[k], ref.Jte0) <= 1e-9 * max(float(ref.Jte0.abs().max()), 1.0)
        assert abs(float(prior.c0[k] - ref.c0)) <= 1e-9 * max(float(ref.c0), 1.0)
        assert max_diff(prior.x0.poses[k], ref.x0.poses) == 0 and float(prior.valid[k]) == 1.0
    for k in CHECKED:
        jpr = one_jax(_jax(probs[k][0]), _jax(probs[k][1]))
        scale = max(float(jnp.abs(jpr.H0).max()), 1.0)
        np.testing.assert_allclose(prior.H0[k].numpy(), np.asarray(jpr.H0), atol=1e-6 * scale)
        np.testing.assert_allclose(prior.Jte0[k].numpy(), np.asarray(jpr.Jte0), atol=1e-6)
        np.testing.assert_allclose(float(prior.c0[k]), float(jpr.c0), rtol=1e-4, atol=1e-9)


def _ins_inputs():
    """tests/test_parallel.py's INS worlds, B of them: S samples of 5 ms,
    identity states at random positions, gravity [0, 0, 9.8], small random
    earth rates (numpy)."""
    rng = np.random.default_rng(9)
    imu = dict(time=np.tile(np.arange(1, S + 1) * 0.005, (B, 1)), dt=np.full((B, S), 0.005),
               dtheta=rng.normal(0, 1e-4, (B, S, 3)), dvel=rng.normal(0.016, 1e-3, (B, S, 3)),
               odovel=np.zeros((B, S)))
    p = rng.normal(0, 1, (B, 3))
    gravity = np.tile([0.0, 0.0, 9.8], (B, 1))
    iewn = rng.normal(0, 1e-5, (B, 3))
    return imu, p, gravity, iewn


def test_sharded_ins_step_matches_single_and_jax():
    imu, p, gravity, iewn = _ins_inputs()
    T = lambda a: torch.tensor(np.asarray(a, np.float64))  # noqa: E731
    t_imu = ttypes.ImuBatch(**{k: T(v) for k, v in imu.items()})
    ident = ttypes.NavState.identity()
    t_st = ttypes.NavState(*[a.expand((B,) + a.shape).clone() for a in ident])._replace(p=T(p))
    int_params = ttypes.IntegrationParams.default()
    fn, place = pmesh.sharded_ins_step(pmesh.make_mesh(MESH), int_params, with_earth=True)
    summ, out = pmesh.gather(fn(*place((t_imu, t_st, T(gravity), T(iewn)))))

    jparams = jtypes.IntegrationParams.default()
    jpre_one = jax.jit(lambda i, s: jpre.preintegrate(jparams, i, s, with_earth=True))
    jmech_one = jax.jit(lambda i, s, g, w: jmech.mechanize_scan(
        jmech.MechConfig(gravity=g, iewn=w, iswithearth=True), s, i)[0])
    for k in range(B):
        imu_k, st_k = element(t_imu, k), element(t_st, k)
        ref_s = tpre.preintegrate(int_params, imu_k, st_k, with_earth=True)
        ref_m, _ = tmech.mechanize_scan(tmech.MechConfig(gravity=T(gravity[k]), iewn=T(iewn[k])), st_k, imu_k)
        for name in tpre.PreintSummary._fields:
            a, b = getattr(summ, name)[k], getattr(ref_s, name)
            assert max_diff(a, b) <= 1e-9 * max(float(b.abs().max()), 1.0), name
        for name in ("time", "p", "q", "v"):
            assert max_diff(getattr(out, name)[k], getattr(ref_m, name)) <= 1e-9, name
        if k in CHECKED:
            j_imu = jtypes.ImuBatch(**{f: jnp.asarray(v[k]) for f, v in imu.items()})
            j_st = jtypes.NavState.identity()._replace(p=jnp.asarray(p[k]))
            check_summary(element(summ, k), jpre_one(j_imu, j_st))
            jm = jmech_one(j_imu, j_st, jnp.asarray(gravity[k]), jnp.asarray(iewn[k]))
            for name, tol in (("p", 1e-9), ("q", 1e-11), ("v", 1e-10), ("time", 0)):
                np.testing.assert_allclose(getattr(out, name)[k].numpy(), np.asarray(getattr(jm, name)),
                                           atol=tol, err_msg=name)


def _frames():
    """tests/test_parallel.py's worlds, B of them: blurred random images,
    the second shifted by (3, 2) px, F random points."""
    rng = np.random.default_rng(5)
    base = rng.uniform(0, 255, (B, H + 8, W + 8)).astype(np.float32)
    for _ in range(2):
        base = 0.25 * (base + np.roll(base, 1, 1) + np.roll(base, 1, 2) + np.roll(base, -1, 1))
    prev = np.ascontiguousarray(base[:, 4:H + 4, 4:W + 4])
    cur = np.ascontiguousarray(base[:, 2:H + 2, 1:W + 1])
    pts = rng.uniform(20, 100, (B, F, 2)).astype(np.float32)
    return prev, cur, pts, np.ones((B, F), bool)


@pytest.fixture
def jax_ransac_table(monkeypatch):
    """The port's RANSAC draws the reference's hypothesis table."""
    monkeypatch.setattr(transac, "_draw_samples", lambda valid, num_hyp, generator: torch.tensor(
        np.asarray(_jax_table(jnp.asarray(valid.numpy())))))


def test_sharded_frontend_matches_single_and_jax(jax_ransac_table):
    prev, cur, pts, valid = _frames()
    fn, place = pmesh.sharded_frontend(pmesh.make_mesh(MESH), (H, W), **FRAME_KW)
    args = tuple(torch.tensor(a) for a in (prev, cur, pts, valid))
    nxt, ok, corners, cvalid = pmesh.gather(fn(*place(args)))
    frame1 = pmesh.frontend_frame_fn((H, W), **FRAME_KW)
    for k in range(B):
        rn, ro, rc, rv = frame1(*(a[k] for a in args))
        assert torch.equal(ok[k], ro) and torch.equal(cvalid[k], rv)
        assert torch.equal(nxt[k][ro], rn[ro]) and torch.equal(corners[k][rv], rc[rv])
    # the tracks follow the (3, 2) px shift
    shift = (nxt[0] - args[2][0])[ok[0]]
    assert int(ok[0].sum()) > F // 3
    np.testing.assert_allclose(shift.median(dim=0).values.numpy(), [3.0, 2.0], atol=0.3)

    jframe = jax.jit(jmesh.frontend_frame_fn((H, W), **FRAME_KW))
    for k in CHECKED:
        jn, jo, jc, jv = (np.asarray(a) for a in jframe(*(jnp.asarray(a[k]) for a in (prev, cur, pts, valid))))
        both = ok[k].numpy() & jo
        assert int((ok[k].numpy() != jo).sum()) <= 2
        np.testing.assert_allclose(nxt[k].numpy()[both], jn[both], atol=0.05)
        same = cvalid[k].numpy() & (jv > 0)
        assert int((cvalid[k].numpy() != (jv > 0)).sum()) <= 2 * FRAME_KW["block"][2]
        np.testing.assert_allclose(corners[k].numpy()[same], jc[same], atol=0.5)


# ---------------------------------------------------------------------------
# pieces
# ---------------------------------------------------------------------------

def test_plain_kernels_world_axis_match_unbatched_calls():
    """clahe_apply_plain, lk_pyr_plain and subpix_plain over a world axis
    equal one unbatched call per world, bit for bit."""
    prev, cur, pts, valid = (torch.tensor(a[:3]) for a in _frames())
    tables = tpyr.clahe_tables(prev)
    out = kclahe.clahe_apply_plain(*tables)
    pyr_p, pyr_c = tpyr.build_pyramid(out, 3), tpyr.build_pyramid(tpyr.clahe(cur), 3)
    valid[1, ::3] = False
    fwd, okb = klk.lk_pyr_plain(pyr_p, pyr_c, pts, pts + 1.0, valid, levels=3)
    steps = torch.zeros(valid.shape, dtype=torch.int32)
    refined = ksubpix.subpix_plain(pyr_c[0], pts, valid, steps=steps)
    for k in range(3):
        tk = tpyr.clahe_tables(prev[k])
        assert torch.equal(tables[0][k], tk[0]) and torch.equal(tables[1][k], tk[1])
        assert torch.equal(out[k], kclahe.clahe_apply_plain(*tk))
        f1, o1 = klk.lk_pyr_plain([lv[k] for lv in pyr_p], [lv[k] for lv in pyr_c], pts[k], pts[k] + 1.0,
                                  valid[k], levels=3)
        assert torch.equal(fwd[k], f1) and torch.equal(okb[k], o1)
        s1 = torch.zeros(F, dtype=torch.int32)
        assert torch.equal(refined[k], ksubpix.subpix_plain(pyr_c[0][k], pts[k], valid[k], steps=s1))
        assert torch.equal(steps[k], s1)
    assert int(okb.sum()) > 0 and int(steps.sum()) > 0
    # the wrappers route CPU tensors with a world axis to the plain versions
    assert torch.equal(kclahe.clahe_apply(*tables), out)
    assert torch.equal(ksubpix.subpix(pyr_c[0], pts, valid), refined)


def test_over_problems_forms_match_single_calls():
    """The batched forms of the problem's functions (over_problems) equal
    their single calls, element by element, within 1e-12 of each output's
    scale (block_matvec's batched product sums in another order)."""
    _, port = problems(7)
    params, tables = pmesh.stack([p for p, _ in port]), pmesh.stack([t for _, t in port])
    dx = torch.tensor(np.random.default_rng(1).normal(0, 1e-3, (B, CFG.D)))
    blocks = tprob.over_problems(tprob.build_normal_blocks, CFG)(params, tables)
    gauged = tprob.over_problems(tprob.apply_gauge_blocks, CFG)(*blocks)
    forms = dict(
        blocks=(blocks, lambda p, t, d: tprob.build_normal_blocks(p, t, CFG)),
        gauged=(gauged, lambda p, t, d: tprob.apply_gauge_blocks(*tprob.build_normal_blocks(p, t, CFG), CFG)),
        matvec=(tprob.over_problems(tprob.block_matvec, CFG)(*gauged[:3], dx),
                lambda p, t, d: tprob.block_matvec(*tprob.apply_gauge_blocks(
                    *tprob.build_normal_blocks(p, t, CFG), CFG)[:3], d, CFG)),
        cost=(tprob.over_problems(tprob.total_cost, CFG)(params, tables),
              lambda p, t, d: tprob.total_cost(p, t, CFG)),
        chi2=(tprob.over_problems(tprob.chi2_blocks, CFG)(params, tables),
              lambda p, t, d: tprob.chi2_blocks(p, t, CFG)),
        boxplus=(tprob.over_problems(lambda p, d, cfg: p.boxplus(cfg, d), CFG)(params, dx),
                 lambda p, t, d: p.boxplus(CFG, d)))
    for name, (batched, single) in forms.items():
        for k in range(B):
            ref = single(*port[k], dx[k])
            got = element(batched, k)
            for a, b in zip(*((got, ref) if isinstance(ref, tuple) else ((got,), (ref,)))):
                assert max_diff(a, b) <= 1e-12 * max(float(b.abs().max()), 1.0), (name, k)


def test_batched_lm_stops_each_problem_at_its_own_done():
    """A converged problem beside a fresh one: each element takes the
    accepted steps of its own single solve, the converged one stopping
    early with its params, cost and radius frozen; the loop reads the
    device once an iteration and runs as long as the slowest problem. Over
    the fresh problem's 20 iterations the rounding drift of the module
    docstring reaches ~3e-9 in its poses (bound 1e-7, cost 1e-9 relative)."""
    _, port = problems(3)
    (p0, t0), (p1, t1) = port[0], port[1]
    conv, _, _ = tlm.solve(p0, t0, CFG, 50)
    single, reads = [], []
    for p, t in ((conv, t0), (p1, t1)):
        r0 = fetch.reads
        single.append(tlm.solve(p, t, CFG, 20))
        reads.append(fetch.reads - r0)
    r0 = fetch.reads
    out, stats, radius = tlm.solve_batched(pmesh.stack([conv, p1]), pmesh.stack([t0, t1]), CFG, 20)
    assert fetch.reads - r0 == max(reads) and reads[0] < reads[1]
    for k, (ref, ref_stats, ref_radius) in enumerate(single):
        assert int(stats.iterations[k]) == int(ref_stats.iterations)
        np.testing.assert_allclose(float(stats.final_cost[k]), float(ref_stats.final_cost), rtol=1e-9)
    (ref0, _, radius0), (ref1, _, _) = single
    assert max_diff(out.poses[0], ref0.poses) <= 1e-12 and float(radius[0]) == float(radius0)
    assert max_diff(out.poses[1], ref1.poses) <= 1e-7
    assert int(stats.iterations[0]) < int(stats.iterations[1])


def test_make_mesh_and_place():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pmesh.make_mesh()
    mesh = pmesh.make_mesh(["cpu"] * 4)
    x = torch.arange(8.0)
    placed = pmesh._placer(mesh)((x,))
    assert [len(s) for s in placed[0]] == [2] * 4
    placed[0][0][0] = -1.0                      # a copy: the input is untouched
    assert float(x[0]) == 0.0
    with pytest.raises(ValueError, match="does not split"):
        pmesh._placer(mesh)((torch.arange(6.0),))


@pytest.mark.parametrize("with_odo", [False, True])
def test_chip_smoke_np_problem_is_graft_copy(with_odo):
    for seed in (0, 5):
        ref = ge._np_problem(jprob.WindowConfig(N=6, L=32, G=8, R=64, with_odo=with_odo), seed=seed)
        got = chip_smoke.np_problem(tprob.WindowConfig(N=6, L=32, G=8, R=64, with_odo=with_odo), seed=seed)
        ref_leaves = jax.tree_util.tree_leaves(ref)
        got_leaves = jax.tree_util.tree_leaves(got)
        assert len(ref_leaves) == len(got_leaves)
        for a, b in zip(got_leaves, ref_leaves):
            assert np.asarray(a).dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert [type(t).__name__ for t in got[1]] == [type(t).__name__ for t in ref[1]]
