"""Port parity: camera undistortion (f64), fundamental RANSAC and two-view
triangulation (ic_gvins_tpu_torch.vision.camera / ransac), plus the camera
carried over by ic_gvins_tpu_torch.convert."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from test_torch_harness import jax_compile_cache  # noqa: F401 (autouse: the run's compile cache)
from test_vision_kernels import kaist_camera
from ic_gvins_tpu.core import quaternion as quat
from ic_gvins_tpu.vision import camera as jcam
from ic_gvins_tpu.vision import ransac as jransac
from ic_gvins_tpu_torch.convert import camera_from_vec
from ic_gvins_tpu_torch.vision import camera as tcam
from ic_gvins_tpu_torch.vision import ransac as transac

torch.set_num_threads(1)


def _port_camera():
    c = kaist_camera()
    vec = [c.fx, c.fy, c.cx, c.cy, c.skew, c.k1, c.k2, c.k3, c.p1, c.p2]
    return camera_from_vec(np.asarray(vec), c.width, c.height)


def test_camera_from_vec_roundtrip():
    c = kaist_camera()
    assert tuple(_port_camera()) == tuple(c)


def test_undistort_points_f64():
    """torch f64 undistortion against the reference within 1e-9 px; the
    numpy branch too."""
    px = np.random.default_rng(0).uniform([0, 0], [1278, 1022], (256, 2))
    ref = np.asarray(jcam.undistort_points(kaist_camera(), jnp.asarray(px)))
    out = tcam.undistort_points(_port_camera(), torch.tensor(px, dtype=torch.float64))
    assert out.dtype == torch.float64
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-9)
    np.testing.assert_allclose(tcam.undistort_points(_port_camera(), px), ref, rtol=0, atol=1e-9)
    dis = tcam.distort_points(_port_camera(), torch.tensor(ref, dtype=torch.float64))
    want = np.asarray(jcam.distort_points(kaist_camera(), jnp.asarray(ref)))
    np.testing.assert_allclose(dis.numpy(), want, rtol=0, atol=1e-9)


def _two_view(seed=11, n=120, N=160):
    rng = np.random.default_rng(seed)
    c = kaist_camera()
    pw = rng.uniform(-3, 3, (n, 3)) + [0, 0, 10]
    R1 = np.asarray(quat.to_matrix(quat.from_rotvec(jnp.array([0.02, -0.01, 0.03]))))
    t1 = np.array([0.5, 0.1, 0.0])
    pc1 = (pw - t1) @ R1
    px0 = np.asarray(jcam.cam2pixel(c, jnp.asarray(pw / pw[:, 2:3])))
    px1 = np.array(jcam.cam2pixel(c, jnp.asarray(pc1 / pc1[:, 2:3])))
    px1 += rng.normal(0, 0.3, px1.shape)
    bad = rng.choice(n, 20, replace=False)
    px1[bad] += rng.uniform(15, 40, (20, 2)) * rng.choice([-1, 1], (20, 2))
    pts0, pts1, val = np.zeros((N, 2)), np.zeros((N, 2)), np.zeros(N)
    pts0[:n], pts1[:n], val[:n] = px0, px1, 1.0
    return pts0, pts1, val, bad


@jax.jit
def _jax_table(valid):
    """The reference's hypothesis draw (ransac.py:149-153)."""
    probs = valid / jnp.maximum(jnp.sum(valid), 1.0)
    return jax.random.choice(jax.random.PRNGKey(0), valid.shape[0], shape=(256, 8), p=probs)


def test_fundamental_ransac_identical_inliers(monkeypatch):
    """Given the reference's sample table, the inlier mask is identical."""
    pts0, pts1, val, bad = _two_view()
    inl_j, cnt_j = jransac.fundamental_ransac(jnp.asarray(pts0), jnp.asarray(pts1),
                                              jnp.asarray(val), 1.5)
    table = np.asarray(_jax_table(jnp.asarray(val)))
    monkeypatch.setattr(transac, "_draw_samples",
                        lambda valid, num_hyp, generator: torch.tensor(table))
    f64 = torch.float64
    inl_t, cnt_t = transac.fundamental_ransac(torch.tensor(pts0, dtype=f64),
                                              torch.tensor(pts1, dtype=f64),
                                              torch.tensor(val, dtype=f64), 1.5)
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
    assert int(cnt_t) == int(cnt_j)
    assert inl_t.numpy()[bad].mean() < 0.2


def test_fundamental_ransac_own_draw_is_deterministic():
    """The port's own torch.Generator draw: same call, same mask; outliers cut."""
    pts0, pts1, val, bad = _two_view(seed=5)
    args = [torch.tensor(a, dtype=torch.float64) for a in (pts0, pts1, val)]
    a, _ = transac.fundamental_ransac(*args, 1.5)
    b, _ = transac.fundamental_ransac(*args, 1.5)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    good = np.setdiff1d(np.arange(120), bad)
    assert a.numpy()[good].mean() > 0.95 and a.numpy()[bad].mean() < 0.2


def test_triangulate_batch():
    """<= 1e-6 relative against the reference, shared and per-point pose1."""
    rng = np.random.default_rng(13)
    n = 64
    pw = rng.uniform(-4, 4, (n, 3)) + [0, 0, 12]
    R0 = np.asarray(quat.to_matrix(quat.from_rotvec(jnp.asarray(rng.normal(0, 0.05, (n, 3))))))
    t0 = rng.normal(0, 0.3, (n, 3))
    R1 = np.asarray(quat.to_matrix(quat.from_rotvec(jnp.array([0.05, 0.02, -0.03]))))
    t1 = np.array([1.0, 0.2, 0.1])
    pc0 = np.einsum("nji,nj->ni", R0, pw - t0)
    pc0 = pc0 / pc0[:, 2:3]
    pc1 = (pw - t1) @ R1
    pc1 = pc1 / pc1[:, 2:3]
    args = (R0, t0, R1, t1, pc0, pc1)
    ref = np.asarray(jransac.triangulate_batch(*map(jnp.asarray, args)))
    out = transac.triangulate_batch(*[torch.tensor(a, dtype=torch.float64) for a in args]).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=0)
    np.testing.assert_allclose(out, pw, rtol=1e-6, atol=0)

    R1n, t1n = np.tile(R1, (n, 1, 1)), np.tile(t1, (n, 1))
    out_n = transac.triangulate_batch(*[torch.tensor(a, dtype=torch.float64)
                                        for a in (R0, t0, R1n, t1n, pc0, pc1)]).numpy()
    np.testing.assert_allclose(out_n, ref, rtol=1e-6, atol=0)
