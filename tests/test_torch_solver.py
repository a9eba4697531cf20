"""The port's window problem and LM solver against the JAX twins on the CPU:
normal-equation blocks, total cost and chi2 on a problem with every factor
type and a live marginalization prior; a few LM iterations against the JAX
solver's f64 mode (``precise=True``: f64 factorization, f64 reprojection);
the Schur solve against a dense solve; the chi2 surgery; and the two-pass
solve on a GNSS/INS window with a gross GNSS outlier."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from test_lm import build_gins_problem, perturb
from test_torch_harness import jax_compile_cache  # noqa: F401 (autouse: the run's compile cache)
from ic_gvins_tpu.solver import lm as jlm
from ic_gvins_tpu.solver import problem as jprob
from ic_gvins_tpu_torch import convert
from ic_gvins_tpu_torch.solver import lm as tlm
from ic_gvins_tpu_torch.solver import problem as tprob

torch.set_num_threads(1)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def close(port, ref, atol):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), atol=atol)


def problem(with_earth, seed=3):
    """graft's window (GNSS + preintegration + reprojection), perturbed, with
    the extrinsic and td columns active and a marginalization prior whose
    linearization point is rotated away from the parameters. Returns numpy
    trees (params, tables) and the config."""
    cfg = jprob.WindowConfig(N=6, L=32, G=8, R=128, with_earth=with_earth)
    params, tables = graft._np_problem(cfg, seed=1)
    rng = np.random.default_rng(seed)
    d = np.concatenate([rng.normal(0, 0.03, (cfg.N, 3)), rng.normal(0, 0.01, (cfg.N, 3))], axis=1)
    poses = np.asarray(jax.vmap(jprob.quat.boxplus_pose)(jnp.asarray(params.poses), jnp.asarray(d)))
    params = params._replace(poses=poses, invdepths=params.invdepths + rng.normal(0, 0.005, cfg.L))
    NP = cfg.lm_off
    A = rng.normal(size=(NP, NP))
    x0 = params._replace(poses=np.asarray(jax.vmap(jprob.quat.boxplus_pose)(
        jnp.asarray(poses), jnp.asarray(rng.normal(0, 0.02, (cfg.N, 6))))))
    marg = tables.marg._replace(H0=A @ A.T / NP + np.eye(NP), Jte0=rng.normal(size=NP), c0=np.asarray(3.0),
                                x0=x0, valid=np.asarray(1.0))
    summ = tables.preint.summ._replace(iewn=np.tile([6e-5, 0.0, -4e-5], (cfg.P, 1)),
                                       sum_dtpn=rng.normal(0, 1, (cfg.P, 3)))
    tables = tables._replace(ext_active=np.asarray(1.0), td_active=np.asarray(1.0), marg=marg,
                             preint=tables.preint._replace(summ=summ),
                             gnss=tables.gnss._replace(blh=tables.gnss.blh + np.where(
                                 np.arange(cfg.G)[:, None] == 1, 2.0, 0.0)))   # one Huber-active row
    return cfg, params, tables


def both(params, tables):
    j = (jax.tree_util.tree_map(jnp.asarray, params), jax.tree_util.tree_map(jnp.asarray, tables))
    return j, (convert.window_params(params, "cpu"), convert.factor_tables(tables, "cpu"))


@pytest.mark.parametrize("with_earth", [False, True])
def test_normal_blocks_cost_and_chi2_match_jax(with_earth):
    """index_add_ assembly equals the JAX block assembly (f64 reprojection):
    1e-9 of the scale of H and b; total cost and chi2 to 1e-9 relative."""
    cfg, params, tables = problem(with_earth)
    (jp, jt), (tp, tt) = both(params, tables)
    ref = jprob.build_normal_blocks(jp, jt, cfg, reproj_f64=True)
    port = tprob.build_normal_blocks(tp, tt, cfg)
    for name, a, b in zip(("Hss", "Hsl", "hll", "b", "act"), port, ref):
        close(a, b, 1e-9 * max(1.0, float(jnp.abs(b).max())))
    for a, b in zip(tprob.apply_gauge_blocks(*port, cfg), jprob.apply_gauge_blocks(*ref, cfg)):
        close(a, b, 1e-9 * max(1.0, float(jnp.abs(b).max())))
    jc = float(jprob.total_cost(jp, jt, cfg, reproj_f64=True))
    np.testing.assert_allclose(float(tprob.total_cost(tp, tt, cfg)), jc, rtol=1e-9)
    for a, b in zip(tprob.chi2_blocks(tp, tt, cfg), jprob.chi2_blocks(jp, jt, cfg)):
        close(a, b, 1e-4 * max(1.0, float(jnp.abs(b).max())))   # the JAX chi2 reads f32 reprojection
    x = np.random.default_rng(0).normal(size=cfg.D)
    close(tprob.block_matvec(*port[:3], torch.tensor(x), cfg), jprob.block_matvec(*ref[:3], jnp.asarray(x), cfg),
          1e-9 * float(jnp.abs(ref[0]).max()))


def test_padded_rows_add_exact_zeros():
    """Padded GNSS, preintegration and reprojection rows (index 0 or 1,
    valid 0) add exact zeros: filling them with other finite values leaves
    the normal equations and the cost bit for bit unchanged."""
    cfg, params, tables = problem(True)
    (_, _), (tp, tt) = both(params, tables)
    g, pr, r = tt.gnss, tt.preint, tt.reproj
    pad_g, pad_p, pad_r = g.valid == 0, pr.valid == 0, r.valid == 0
    assert pad_g.any() and pad_p.any() and pad_r.any()
    junk = tt._replace(
        gnss=g._replace(blh=torch.where(pad_g[:, None], 123.0, g.blh), std=torch.where(pad_g[:, None], 0.5, g.std)),
        preint=pr._replace(summ=pr.summ._replace(dp=torch.where(pad_p[:, None], 7.0, pr.summ.dp))),
        reproj=r._replace(pts1=torch.where(pad_r[:, None], torch.tensor([0.3, -0.2, 1.0], dtype=torch.float64),
                                           r.pts1)))
    for a, b in zip(tprob.build_normal_blocks(tp, junk, cfg), tprob.build_normal_blocks(tp, tt, cfg)):
        assert torch.equal(a, b)
    assert torch.equal(tprob.total_cost(tp, junk, cfg), tprob.total_cost(tp, tt, cfg))


def test_schur_solve_matches_dense_solve():
    cfg, params, tables = problem(False)
    (_, _), (tp, tt) = both(params, tables)
    Hss, Hsl, hll, b = tprob.apply_gauge_blocks(*tprob.build_normal_blocks(tp, tt, cfg), cfg)
    mu = 1e-3 * torch.clamp(torch.cat([torch.diagonal(Hss), hll]), 1e-6, 1e32)
    dx = tlm._schur_solve(Hss, Hsl, hll, b, mu, cfg).numpy()
    H = np.block([[Hss.numpy(), Hsl.numpy()], [Hsl.numpy().T, np.diag(hll.numpy())]]) + np.diag(mu.numpy())
    ref = np.linalg.solve(H, b.numpy())
    np.testing.assert_allclose(dx, ref, atol=1e-8 * np.abs(ref).max())
    # a failed factorization (NaN in H) yields the zero step, no exception
    bad = tlm._schur_solve(Hss * float("nan"), Hsl, hll, b, mu, cfg)
    assert torch.equal(bad, torch.zeros_like(bad))


@pytest.mark.parametrize("with_earth", [False, True])
def test_lm_iterations_match_jax_precise(with_earth):
    """5 LM iterations from the same start: parameters within 1e-7, initial
    cost within 1e-9 and final cost within 1e-7 relative, radius within 1e-6
    relative, equal accepted-step counts. (The JAX f64 mode adds one
    refinement pass to each step; the port's f64 factor needs none.)"""
    cfg, params, tables = problem(with_earth)
    (jp, jt), (tp, tt) = both(params, tables)
    jout, jst, jrad = jax.jit(lambda p, t: jlm.solve(p, t, cfg, 5, precise=True))(jp, jt)
    tout, tst, trad = tlm.solve(tp, tt, cfg, 5)
    assert int(tst.iterations) == int(jst.iterations) >= 2
    np.testing.assert_allclose(float(tst.initial_cost), float(jst.initial_cost), rtol=1e-9)
    np.testing.assert_allclose(float(tst.final_cost), float(jst.final_cost), rtol=1e-7)
    close(tout.poses, jout.poses, 1e-7)
    close(tout.mixes, jout.mixes, 1e-7)
    close(tout.invdepths, jout.invdepths, 1e-7)
    close(tout.ext, jout.ext, 1e-7)
    np.testing.assert_allclose(float(trad), float(jrad), rtol=1e-6)


def test_outlier_surgery_matches_jax():
    cfg, params, tables = problem(False)
    (jp, jt), (tp, tt) = both(params, tables)
    jt2, jng, jnr = jlm.outlier_surgery(jp, jt, cfg)
    tt2, tng, tnr = tlm.outlier_surgery(tp, tt, cfg)
    assert int(tng) == int(jng) >= 1 and int(tnr) == int(jnr)
    close(tt2.gnss.std, jt2.gnss.std, 1e-9)
    close(tt2.reproj.valid, jt2.reproj.valid, 0)
    assert float(tt2.gnss.robust) == 0.0


def test_two_pass_reweights_gnss_outlier():
    """tests/test_lm.py's two-pass case through the port: the corrupted GNSS
    fix is flagged, its std inflated, and every node stays within 0.2 m of
    truth."""
    jt, truth, _, n_nodes = build_gins_problem(noise_gnss=0.02, seed=7)
    jt = jt._replace(gnss=jt.gnss._replace(blh=jt.gnss.blh.at[2].add(jnp.array([3.0, -2.0, 1.0]))))
    p0 = perturb(truth, n_nodes, seed=8, dp=0.2)
    cfg = jprob.WindowConfig(N=8, L=64, G=8, R=256, with_earth=False)
    tt = convert.factor_tables(np_tree(jt), "cpu")
    params, tt2, (s1, s2, n_gnss_out, _) = tlm.solve_two_pass(convert.window_params(np_tree(p0), "cpu"), tt, cfg, 20)
    assert int(n_gnss_out) >= 1
    assert float(tt2.gnss.std[2, 0]) > 2 * float(tt.gnss.std[2, 0])
    err = np.linalg.norm(params.poses[:n_nodes, :3].numpy() - np.asarray(truth.poses[:n_nodes, :3]), axis=1)
    assert err.max() < 0.2, err
