"""The port's marginalization against its JAX twin and against the
regression gates of tests/test_marginalization.py, on the CPU, on that
file's 8-node GNSS/INS world: the prior equals the dense Schur complement
(the gate of the relative cut: the constant c0 stays at residual
scale); the assembled gradient matches autograd of the total cost with the
prior's linearization point rotated away (the Jr⁻¹ chaining);
marginalize-and-continue matches the batch solve; dropping a node keeps the
marginal; and shift / drop / insert remap the prior's columns exactly as the
JAX package does."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthetic import stack_summaries
from test_marginalization import CFG, N_NODES, build_world, make_tables
from test_torch_harness import jax_compile_cache  # noqa: F401 (autouse: the run's compile cache)
from ic_gvins_tpu.factors import marginalization as jmarg
from ic_gvins_tpu.solver import problem as jprob
from ic_gvins_tpu_torch import convert
from ic_gvins_tpu_torch.factors import marginalization as tmarg
from ic_gvins_tpu_torch.solver import lm as tlm
from ic_gvins_tpu_torch.solver import problem as tprob

torch.set_num_threads(1)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jx(tree):
    """A port tree with jnp leaves (JAX functions read it by field name)."""
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a.numpy()), tree)


def jparams(p):
    return jprob.WindowParams(*[jnp.asarray(x.numpy()) for x in p])


def jprior(pr):
    return jprob.MargPrior(H0=jnp.asarray(pr.H0.numpy()), Jte0=jnp.asarray(pr.Jte0.numpy()),
                           c0=jnp.asarray(pr.c0.numpy()), x0=jparams(pr.x0), valid=jnp.asarray(pr.valid.numpy()))


@pytest.fixture(scope="module")
def world():
    """For seeds 0/3/5/9: the JAX world (states, summaries, GNSS, truth)."""
    return {s: build_world(seed=s) for s in (0, 3, 5, 9)}


def port_tables(world, seed, n_active):
    states, summs, gnss_pos, truth = world[seed]
    return convert.factor_tables(np_tree(make_tables(states, summs, gnss_pos, n_active, truth)), "cpu")


def port_truth(world, seed):
    return convert.window_params(np_tree(world[seed][3]), "cpu")


def solved_prior(world, seed, n_active, num_marg=2, iters=40):
    tables = port_tables(world, seed, n_active)
    params, _, _ = tlm.solve(port_truth(world, seed), tables, CFG, iters)
    marg_tables, mask, _ = tmarg.select_marg_factors(tables, CFG, num_marg, 0)
    return params, tables, marg_tables, mask, tmarg.marginalize(params, marg_tables, mask, CFG)


def dense(Hss, Hsl, hll):
    return np.block([[Hss.numpy(), Hsl.numpy()], [Hsl.numpy().T, np.diag(hll.numpy())]])


def test_prior_matches_schur_complement_and_jax(world):
    """H0 and Jte0 equal the eigen-pseudo-inverse Schur complement of the
    dense system (1e-6 of H's scale; 1e-6); the JAX marginalize at the same
    parameters agrees (its f32-seeded factor: 1e-6 of scale, c0 1e-4
    relative); c0 stays at residual scale."""
    params, tables, marg_tables, mask, prior = solved_prior(world, 0, N_NODES, iters=30)
    Hss, Hsl, hll, b, act = tprob.build_normal_blocks(params, marg_tables, CFG)
    H, bn = dense(Hss, Hsl, hll), b.numpy()
    m = mask.numpy()
    r = (1 - m) * act.numpy()
    Hmm, Hrm, Hrr = H * np.outer(m, m), H * np.outer(r, m), H * np.outer(r, r)
    w, V = np.linalg.eigh(0.5 * (Hmm + Hmm.T))
    winv = np.where(w > 1e-8, 1 / np.where(w > 1e-8, w, 1), 0)
    Hmm_inv = (V * winv) @ V.T
    Hp = Hrr - Hrm @ Hmm_inv @ Hrm.T
    bp = bn * r - Hrm @ (Hmm_inv @ (bn * m))
    NP = CFG.lm_off
    scale = max(np.abs(Hp).max(), 1.0)
    np.testing.assert_allclose(prior.H0.numpy(), Hp[:NP, :NP], atol=1e-6 * scale)
    np.testing.assert_allclose(prior.Jte0.numpy(), -bp[:NP], atol=1e-6)

    jt = jx(tables)._replace(marg=jprior(tables.marg))
    jmt, jmask, _ = jmarg.select_marg_factors(jt, CFG, 2, 0)
    np.testing.assert_array_equal(np.asarray(jmask), mask.numpy())
    jpr = jmarg.marginalize(jparams(params), jmt, jmask, CFG)
    np.testing.assert_allclose(prior.H0.numpy(), np.asarray(jpr.H0), atol=1e-6 * scale)
    np.testing.assert_allclose(prior.Jte0.numpy(), np.asarray(jpr.Jte0), atol=1e-6)
    np.testing.assert_allclose(float(prior.c0), float(jpr.c0), rtol=1e-4, atol=1e-9)
    assert float(prior.c0) < 10.0 * float(tprob.total_cost(params, marg_tables, CFG)) + 1.0


def test_replayed_prior_gradient_consistent_and_cost_bounded(world):
    """Gate (a): c0 within 10x the absorbed factors' cost + 1. Gate (b): with
    every node rotated away from the linearization point, the assembled b
    equals -autograd of total_cost (2 % of the largest gradient entry)."""
    params, tables, marg_tables, mask, prior = solved_prior(world, 5, 6)
    pre_cost = float(tprob.total_cost(params, marg_tables, CFG))
    assert float(prior.c0) < 10.0 * pre_cost + 1.0, (float(prior.c0), pre_cost)

    g = tables.gnss
    tables2 = tables._replace(
        gnss=g._replace(valid=g.valid * (torch.arange(CFG.G) >= 2)),
        preint=tables.preint._replace(valid=tables.preint.valid * (tables.preint.idx0 >= 2)),
        prior=tables.prior._replace(valid=torch.zeros((), dtype=torch.float64)), marg=prior)
    rng = np.random.default_rng(7)
    d = torch.zeros(CFG.D, dtype=torch.float64)
    for k in range(6):
        d[k * 15: k * 15 + 3] = torch.tensor(rng.normal(0, 0.05, 3))
        d[k * 15 + 3: k * 15 + 6] = torch.tensor(rng.normal(0, 0.02, 3))
    p2 = params.boxplus(CFG, d)
    Hss, Hsl, hll, b, act = tprob.build_normal_blocks(p2, tables2, CFG)
    b = tprob.apply_gauge_blocks(Hss, Hsl, hll, b, act, CFG)[3]
    dx = torch.zeros(CFG.D, dtype=torch.float64, requires_grad=True)
    g_auto, = torch.autograd.grad(tprob.total_cost(p2.boxplus(CFG, dx), tables2, CFG), dx)
    g_auto = g_auto * act
    gmax = float(g_auto.abs().max())
    err = float((b + g_auto).abs().max())
    assert err < 0.02 * max(gmax, 1e-3), f"gradient mismatch {err} vs |g|max {gmax}"


def test_sliding_window_equivalence(world):
    """Marginalize nodes 0-1 of a 6-node solve, shift, add nodes 6-7: the
    retained nodes match the 8-node batch solve within 5 mm."""
    states, summs, gnss_pos, truth = world[3]
    full, _, _ = tlm.solve(port_truth(world, 3), port_tables(world, 3, N_NODES), CFG, 40)
    params6, tables6, marg_tables, mask, prior = solved_prior(world, 3, 6)
    prior = tmarg.shift_prior(prior, CFG, 2)
    t = port_tables(world, 3, N_NODES)
    truth_t = port_truth(world, 3)
    poses = torch.roll(params6.poses, -2, 0)
    mixes = torch.roll(params6.mixes, -2, 0)
    poses[4:6], mixes[4:6] = truth_t.poses[6:8], truth_t.mixes[6:8]
    keep = torch.arange(CFG.G) >= 2
    summ = convert.preint_summary(np_tree(stack_summaries(summs[2:], pad_to=CFG.P)), "cpu")
    t = t._replace(
        gnss=t.gnss._replace(idx=torch.where(keep, t.gnss.idx - 2, 0), valid=t.gnss.valid * keep),
        preint=t.preint._replace(summ=summ, idx0=torch.arange(CFG.P),
                                 valid=(torch.arange(CFG.P) < N_NODES - 3).double()),
        prior=t.prior._replace(valid=torch.zeros((), dtype=torch.float64),
                               imuerr_idx=torch.tensor(N_NODES - 3)),
        marg=prior, node_valid=(torch.arange(CFG.N) < N_NODES - 2).double())
    out, _, _ = tlm.solve(params6._replace(poses=poses, mixes=mixes), t, CFG, 40)
    err = torch.linalg.vector_norm(out.poses[:6, :3] - full.poses[2:8, :3], dim=1)
    assert float(err.max()) < 5e-3, err


def test_drop_node_from_prior_preserves_marginal(world):
    """The compacted prior's quadratic equals the original's minimized over
    node k's 15 coordinates (1e-6 relative), and its columns match the JAX
    drop_node_from_prior on the same prior (1e-6 of scale)."""
    _, _, _, _, prior = solved_prior(world, 9, 6)
    k = 3
    pr2 = tmarg.drop_node_from_prior(prior, CFG, k)
    nd = CFG.N * 15
    assert float(pr2.H0[:, nd - 15: nd].abs().max()) == 0.0
    np.testing.assert_array_equal(pr2.x0.poses[k].numpy(), prior.x0.poses[k + 1].numpy())
    H, g, c0 = prior.H0.numpy(), prior.Jte0.numpy(), float(prior.c0)
    NP = CFG.lm_off
    sk = slice(k * 15, (k + 1) * 15)
    rng = np.random.default_rng(11)
    for _ in range(3):
        dxc = rng.normal(0, 0.05, NP)
        dxo = np.zeros(NP)
        dxo[: k * 15] = dxc[: k * 15]
        dxo[(k + 1) * 15: nd] = dxc[k * 15: nd - 15]
        dxo[nd:] = dxc[nd:]
        xk = -np.linalg.pinv(H[sk, sk], rcond=1e-10, hermitian=True) @ (g[sk] + (H @ dxo)[sk])
        dxf = dxo.copy()
        dxf[sk] = xk
        cost_min = 0.5 * (c0 + 2.0 * dxf @ g + dxf @ H @ dxf)
        cost_comp = 0.5 * (float(pr2.c0) + 2.0 * dxc @ pr2.Jte0.numpy() + dxc @ pr2.H0.numpy() @ dxc)
        np.testing.assert_allclose(cost_comp, cost_min, rtol=1e-6, atol=1e-6 * max(abs(cost_min), 1.0))
    jp2 = jmarg.drop_node_from_prior(jprior(prior), CFG, k)
    scale = float(prior.H0.abs().max())
    np.testing.assert_allclose(pr2.H0.numpy(), np.asarray(jp2.H0), atol=1e-6 * scale)
    np.testing.assert_allclose(pr2.Jte0.numpy(), np.asarray(jp2.Jte0), atol=1e-6 * max(1.0, np.abs(g).max()))


def test_shift_and_insert_remap_like_jax(world):
    """shift_prior and insert_node_slot_into_prior are permutations: equal to
    the JAX package's bit for bit; check_insert_capacity refuses a prior whose
    last slot is in use and accepts one whose last slot is free."""
    _, _, _, _, prior = solved_prior(world, 9, 6)
    leaves = lambda pr: [np.asarray(x) for x in (pr.H0, pr.Jte0, pr.c0, *pr.x0, pr.valid)]  # noqa: E731
    for shift in (1, 2):
        a, b = tmarg.shift_prior(prior, CFG, shift), jmarg.shift_prior(jprior(prior), CFG, shift)
        for x, y in zip(leaves(a), leaves(b)):
            np.testing.assert_array_equal(x, y)
    free = tmarg.shift_prior(prior, CFG, 2)
    tmarg.check_insert_capacity(free, CFG)
    for k in (1, 3):
        a, b = tmarg.insert_node_slot_into_prior(free, CFG, k), jmarg.insert_node_slot_into_prior(jprior(free), CFG, k)
        for x, y in zip(leaves(a), leaves(b)):
            np.testing.assert_array_equal(x, y)
    full = free._replace(H0=free.H0 + 1.0)
    with pytest.raises(RuntimeError, match="last node slot"):
        tmarg.check_insert_capacity(full, CFG)
