"""The port's factor library against the JAX twins and against autograd, on
the CPU: GNSS, IMU-error, pose and mix priors, the preintegration factor
(NORMAL and EARTH), the reprojection factor, and the Huber corrector. Each
residual and analytic local jacobian is evaluated on a seeded table of
factors by both packages (f64 rounding tolerances), and each port jacobian is
held against ``torch.autograd.functional.jacobian`` of its residual through
the boxplus retraction (the tolerances of tests/test_factors.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.autograd.functional import jacobian

from test_torch_harness import jax_compile_cache  # noqa: F401 (autouse: the run's compile cache)

from ic_gvins_tpu.core import quaternion as jquat
from ic_gvins_tpu.core.types import ImuBatch as JImu
from ic_gvins_tpu.core.types import IntegrationParams as JParams
from ic_gvins_tpu.core.types import NavState as JNav
from ic_gvins_tpu.factors import basic as jbasic
from ic_gvins_tpu.factors import preint_factor as jpf
from ic_gvins_tpu.factors import reprojection as jrep
from ic_gvins_tpu.factors import robust as jrobust
from ic_gvins_tpu.ins import preintegration as jpre
from ic_gvins_tpu_torch import convert
from ic_gvins_tpu_torch.core import quaternion as tquat
from ic_gvins_tpu_torch.factors import basic as tbasic
from ic_gvins_tpu_torch.factors import preint_factor as tpf
from ic_gvins_tpu_torch.factors import reprojection as trep
from ic_gvins_tpu_torch.factors import robust as trobust

torch.set_num_threads(1)
B = 6


def T(a):
    return torch.tensor(np.asarray(a, np.float64))


def close(port, ref, atol):
    np.testing.assert_allclose(np.asarray(port.detach() if isinstance(port, torch.Tensor) else port),
                               np.asarray(ref), atol=atol)


def rand_poses(rng, n, ang=0.6):
    rv = rng.normal(0, ang, (n, 3))
    q = np.asarray(jquat.from_rotvec(jnp.asarray(rv)))
    return np.concatenate([rng.normal(0, 5, (n, 3)), q], axis=1)


def rand_mixes(rng, n):
    return np.concatenate([rng.normal(0, 2, (n, 3)), rng.normal(0, 1e-3, (n, 3)), rng.normal(0, 1e-2, (n, 3))], 1)


def pose_jac(fn, pose):
    """autograd local jacobian of fn at pose through the boxplus."""
    return jacobian(lambda d: fn(tquat.boxplus_pose(pose, d)), torch.zeros(6, dtype=torch.float64))


def test_gnss_imu_error_and_prior_factors():
    rng = np.random.default_rng(1)
    poses, priors = rand_poses(rng, B), rand_poses(rng, B)
    blh, std = rng.normal(size=(B, 3)), rng.uniform(0.02, 0.2, (B, 3))
    lever = np.array([-0.37, 0.008, 0.353])
    mixes, mprior = rand_mixes(rng, B), rand_mixes(rng, B)
    std6, std9 = rng.uniform(0.01, 0.2, 6), rng.uniform(0.01, 0.2, 9)

    jr = jax.vmap(jbasic.gnss_residual, in_axes=(0, 0, 0, None))(*map(jnp.asarray, (poses, blh, std, lever)))
    jJ = jax.vmap(jbasic.gnss_jacobian, in_axes=(0, 0, None))(*map(jnp.asarray, (poses, std, lever)))
    close(tbasic.gnss_residual(T(poses), T(blh), T(std), T(lever)), jr, 1e-13)
    tJ = tbasic.gnss_jacobian(T(poses), T(std), T(lever))
    close(tJ, jJ, 1e-13)
    close(tJ[0], pose_jac(lambda p: tbasic.gnss_residual(p, T(blh[0]), T(std[0]), T(lever)), T(poses[0])), 1e-7)

    close(tbasic.imu_error_residual(T(mixes)), jbasic.imu_error_residual(jnp.asarray(mixes)), 1e-12)
    close(tbasic.imu_error_jacobian(), jbasic.imu_error_jacobian(), 0)
    close(tbasic.imu_error_jacobian(), jacobian(tbasic.imu_error_residual, T(mixes[0])), 1e-9)

    jpr = jax.vmap(jbasic.pose_prior_residual, in_axes=(0, 0, None))(jnp.asarray(poses), jnp.asarray(priors),
                                                                      jnp.asarray(std6))
    jpJ = jax.vmap(jbasic.pose_prior_jacobian, in_axes=(0, 0, None))(jnp.asarray(poses), jnp.asarray(priors),
                                                                     jnp.asarray(std6))
    close(tbasic.pose_prior_residual(T(poses), T(priors), T(std6)), jpr, 1e-13)
    tpJ = tbasic.pose_prior_jacobian(T(poses), T(priors), T(std6))
    close(tpJ, jpJ, 1e-13)
    close(tpJ[1], pose_jac(lambda p: tbasic.pose_prior_residual(p, T(priors[1]), T(std6)), T(poses[1])), 1e-7)

    close(tbasic.mix_prior_residual(T(mixes), T(mprior), T(std9)),
          jbasic.mix_prior_residual(jnp.asarray(mixes), jnp.asarray(mprior), jnp.asarray(std9)), 1e-13)
    close(tbasic.mix_prior_jacobian(T(std9)), jbasic.mix_prior_jacobian(jnp.asarray(std9)), 0)


def _summaries(with_earth):
    """A table of B preintegration summaries (JAX, vmapped) at seeded states."""
    rng = np.random.default_rng(11)
    n, dt = 41, 0.005
    w = rng.normal(0, 0.3, (B, n, 3))
    f = rng.normal(0, 1.0, (B, n, 3)) + np.array([0, 0, -9.8])
    dts = np.concatenate([np.zeros((B, 1)), np.full((B, n - 1), dt)], 1)
    imu = JImu(time=jnp.asarray(np.tile(dt * np.arange(n), (B, 1))), dt=jnp.asarray(dts),
               dtheta=jnp.asarray(w * dt), dvel=jnp.asarray(f * dt), odovel=jnp.zeros((B, n)))
    st = JNav(time=jnp.zeros(B), p=jnp.asarray(rng.normal(0, 10, (B, 3))),
              q=jnp.asarray(rand_poses(rng, B, 0.5)[:, 3:]), v=jnp.asarray(rng.normal(0, 2, (B, 3))),
              bg=jnp.asarray(rng.normal(0, 1e-3, (B, 3))), ba=jnp.asarray(rng.normal(0, 1e-2, (B, 3))),
              sodo=jnp.zeros(B), sg=jnp.zeros((B, 3)), sa=jnp.zeros((B, 3)))
    params = JParams.default()._replace(gravity=jnp.asarray(9.8))
    iewn = jnp.tile(jnp.array([6e-5, 0.0, -4e-5]), (B, 1)) if with_earth else None
    return jpre.preintegrate_batch(params, imu, st, with_earth=with_earth, iewn_batch=iewn)


@pytest.mark.parametrize("with_earth", [False, True])
def test_preint_factor_matches_jax_and_autograd(with_earth):
    rng = np.random.default_rng(21)
    jsumm = _summaries(with_earth)
    tsumm = convert.preint_summary(jax.tree_util.tree_map(np.asarray, jsumm), "cpu")
    pose0, pose1 = rand_poses(rng, B), rand_poses(rng, B)
    mix0, mix1 = rand_mixes(rng, B), rand_mixes(rng, B)
    mix0[:, 3:6], mix0[:, 6:9] = np.asarray(jsumm.bg0), np.asarray(jsumm.ba0)
    mix0[3:, 3:6] += 1e-4     # half the table off the bias linearization point
    jargs = tuple(map(jnp.asarray, (pose0, mix0, pose1, mix1)))
    targs = tuple(map(T, (pose0, mix0, pose1, mix1)))
    jres = jax.vmap(lambda s, a, b, c, d: jpf.residual(s, a, b, c, d, with_earth=with_earth))(jsumm, *jargs)
    jjac = jax.vmap(lambda s, a, b, c, d: jpf.jacobians(s, a, b, c, d, with_earth=with_earth))(jsumm, *jargs)
    close(tpf.residual(tsumm, *targs, with_earth=with_earth), jres, 1e-9 * float(jnp.abs(jres).max()))
    tjac = tpf.jacobians(tsumm, *targs, with_earth=with_earth)
    for a, b in zip(tjac, jjac):
        close(a, b, 1e-10 * float(jnp.abs(b).max()))

    # autograd at the bias linearization point (row 0): exact jacobians
    s0 = type(tsumm)(*[x[0] for x in tsumm])
    p0, m0, p1, m1 = (x[0] for x in targs)
    res = lambda a, b, c, d: tpf.residual(s0, a, b, c, d, with_earth=with_earth)  # noqa: E731
    J = [pose_jac(lambda p: res(p, m0, p1, m1), p0),
         jacobian(lambda m: res(p0, m, p1, m1), m0),
         pose_jac(lambda p: res(p0, m0, p, m1), p1),
         jacobian(lambda m: res(p0, m0, p1, m), m1)]
    for a, b in zip(tjac, J):
        close(a[0], b, 1e-6)


def test_reprojection_factor_matches_jax_and_autograd():
    rng = np.random.default_rng(41)
    pose0 = rand_poses(rng, B)
    pose1 = pose0.copy()
    pose1[:, :3] += rng.normal(0, 0.2, (B, 3))
    pose1[:, 3:] = np.asarray(jquat.boxplus_pose(jnp.asarray(pose0), jnp.asarray(rng.normal(0, 0.03, (B, 6)))))[:, 3:]
    ext = np.concatenate([[0.074, -0.030, 0.128], np.asarray(jquat.from_rotvec(jnp.array([1.2, -1.2, 1.2])))])
    inv = rng.uniform(0.1, 0.2, B)
    td = np.asarray(0.003)
    pts0 = np.concatenate([rng.normal(0, 0.1, (B, 2)), np.ones((B, 1))], 1)
    pts1 = np.concatenate([rng.normal(0, 0.1, (B, 2)), np.ones((B, 1))], 1)
    vel0 = np.concatenate([rng.normal(0, 0.5, (B, 2)), np.zeros((B, 1))], 1)
    vel1 = np.concatenate([rng.normal(0, 0.5, (B, 2)), np.zeros((B, 1))], 1)
    td0, td1 = rng.uniform(0, 0.005, B), rng.uniform(0, 0.005, B)
    sqi = np.asarray(780.0 / 1.5)
    jfn = lambda f: jax.vmap(lambda p0, p1, iv, a, b, c, d, e, g: f(  # noqa: E731
        p0, p1, jnp.asarray(ext), iv, jnp.asarray(td), a, b, c, d, e, g, jnp.asarray(sqi)))(
        *map(jnp.asarray, (pose0, pose1, inv, pts0, pts1, vel0, vel1, td0, td1)))
    targs = tuple(map(T, (pose0, pose1, ext, inv, td, pts0, pts1, vel0, vel1, td0, td1, sqi)))
    jres = jfn(jrep.residual)
    close(trep.residual(*targs), jres, 1e-9)
    tjac = trep.jacobians(*targs)
    for a, b in zip(tjac, jfn(jrep.jacobians)):
        close(a, b, 1e-8)

    # autograd on row 2 (ext, td and sqrt_info are shared by the table)
    r = 2
    p0, p1, e, iv, tdd, *obs = [x if k in (2, 4, 11) else x[r] for k, x in enumerate(targs)]
    res = lambda a, b, c, d, f: trep.residual(a, b, c, d, f, *obs)  # noqa: E731
    J = [pose_jac(lambda p: res(p, p1, e, iv, tdd), p0), pose_jac(lambda p: res(p0, p, e, iv, tdd), p1),
         pose_jac(lambda p: res(p0, p1, p, iv, tdd), e),
         jacobian(lambda d: res(p0, p1, e, iv + d, tdd), torch.zeros((), dtype=torch.float64))[:, None],
         jacobian(lambda d: res(p0, p1, e, iv, tdd + d), torch.zeros((), dtype=torch.float64))[:, None]]
    for a, b in zip(tjac, J):
        close(a[r], b, 1e-6)


def test_huber_corrector_matches_jax():
    """Active, inactive and disabled kernels over a table; the corrected
    Gauss-Newton gradient equals the robustified gradient."""
    rng = np.random.default_rng(51)
    r = np.concatenate([rng.normal(0, 2.0, (4, 5)), rng.normal(0, 0.1, (4, 5)), np.zeros((1, 5))])
    J = rng.normal(size=(9, 5, 4))
    for use in (True, False):
        jr, jJ = jrobust.correct_blocks(jnp.asarray(r), jnp.asarray(J), use)
        tr, tJ = trobust.correct_blocks(T(r), T(J), torch.tensor(use))
        close(tr, jr, 1e-14)
        close(tJ, jJ, 1e-14)
    tr, tJ = trobust.correct_blocks(T(r), T(J), True)
    s = (r * r).sum(1)
    _, drho, _ = trobust.huber_rho(T(s))
    g_true = drho.numpy()[:, None] * np.einsum("bri,br->bi", J, r)
    close(np.einsum("bri,br->bi", tJ.numpy(), tr.numpy()), g_true, 1e-10)
    for a, b in zip(trobust.huber_rho(T(s)), jrobust.huber_rho(jnp.asarray(s))):
        close(a, b, 1e-15)
