"""Port parity: Shi-Tomasi detection, occupancy mask and subpixel refinement
(ic_gvins_tpu_torch.vision.features; kernel K2's plain route, also on
chip_smoke.py's near-border / divergence-guard set, and its step count)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_harness import jax_compile_cache  # noqa: F401 (autouse: the run's compile cache)
from test_vision_kernels import synth_image
from ic_gvins_tpu.vision import features as jfeat
from ic_gvins_tpu_torch.ops import subpix as ksubpix
from ic_gvins_tpu_torch.vision import features as tfeat

torch.set_num_threads(1)
H, W = 240, 320


def _img(seed=5):
    return synth_image(H=H, W=W, seed=seed).astype(np.float32)


def test_min_eig_response():
    """<= 1e-3 relative to the image's largest response."""
    img = _img()
    ref = np.asarray(jfeat.min_eig_response(jnp.asarray(img)))
    out = tfeat.min_eig_response(torch.tensor(img)).numpy()
    assert np.abs(out - ref).max() <= 1e-3 * np.abs(ref).max()


def _points(seed):
    rng = np.random.default_rng(seed)
    pts = np.concatenate([rng.uniform(-4, [W + 4, H + 4], (40, 2)), [[0.0, 0.0], [W - 0.5, H - 0.5]]])
    wts = (rng.uniform(size=len(pts)) > 0.3).astype(np.float64)
    return pts, wts


def test_occupancy_mask_exact():
    pts, wts = _points(1)
    ref = np.asarray(jfeat.occupancy_mask(jnp.asarray(pts), jnp.asarray(wts), (H, W), 12))
    out = tfeat.occupancy_mask(torch.tensor(pts), torch.tensor(wts), (H, W), 12).numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("masked", [False, True])
def test_detect_blockwise_identical(masked):
    """Identical corner tables and valid flags, with and without an
    occupancy mask and existing per-block counts."""
    img = _img()
    counts = np.array([0, 3, 20, 7], np.int32) if masked else np.zeros(4, np.int32)
    if masked:
        pts, wts = _points(2)
        mask_j = jfeat.occupancy_mask(jnp.asarray(pts), jnp.asarray(wts), (H, W), 12)
        mask_t = tfeat.occupancy_mask(torch.tensor(pts), torch.tensor(wts), (H, W), 12)
    else:
        mask_j, mask_t = jnp.ones((H, W)), torch.ones(H, W)
    kw = dict(block_rows=2, block_cols=2, per_block=30, min_distance=9)
    c_j, _, v_j = jfeat.detect_blockwise(jnp.asarray(img), mask_j, jnp.asarray(counts), **kw)
    c_t, _, v_t = tfeat.detect_blockwise(torch.tensor(img), mask_t, torch.tensor(counts), **kw)
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    assert v_t.sum() > 10


def test_corner_subpix_matches_jnp_path():
    """Against the jnp path of corner_subpix (the CPU reference): median
    < 1e-4 px, max < 1e-2 px, corners within 6 px of the edge included
    (their 13x13 window is clip-shifted)."""
    img = _img(seed=3)
    corners, _, valid = jfeat.detect_blockwise(
        jnp.asarray(img), jnp.ones((H, W)), jnp.zeros(4, jnp.int32),
        block_rows=2, block_cols=2, per_block=20, min_distance=9)
    edge = np.array([[2.0, 50.0], [4.0, 120.0], [100.0, 3.0], [W - 3.0, 200.0],
                     [150.0, H - 2.0], [1.0, 1.0]], np.float32)
    pts = np.concatenate([np.asarray(corners, np.float32), edge])
    v = np.concatenate([np.asarray(valid), np.ones(len(edge), bool)])
    ref = np.asarray(jfeat.corner_subpix(jnp.asarray(img), jnp.asarray(pts), jnp.asarray(v)))
    out = tfeat.corner_subpix(torch.tensor(img), torch.tensor(pts), torch.tensor(v)).numpy()
    d = np.linalg.norm(out - ref, axis=1)
    assert np.median(d[v]) < 1e-4, f"median {np.median(d[v])}"
    assert d.max() < 1e-2, f"max {d.max()}"
    np.testing.assert_array_equal(out[~v], pts[~v])


@pytest.fixture(scope="module")
def edge_set():
    """chip_smoke.py's K2 border/guard set at 320x240, through the jnp path
    and the plain version (with its step count)."""
    img, c, v, kind = chip_smoke.subpix_edge_set(H, W, seed=0)
    ref = np.asarray(jfeat.corner_subpix(jnp.asarray(img), jnp.asarray(c), jnp.asarray(v)))
    steps = torch.zeros(len(c), dtype=torch.int32)
    tc, tv = torch.tensor(c), torch.tensor(v)
    out = ksubpix.subpix_plain(torch.tensor(img), tc, tv, steps=steps)
    clipped, rejected = chip_smoke.subpix_paths(torch, tc, tv, out, steps, W, H)
    return c, v, kind, ref, out.numpy(), clipped.numpy(), rejected.numpy()


@pytest.mark.parametrize("case", chip_smoke.SUBPIX_CASES)
def test_subpix_edge_set_matches_jnp_path(edge_set, case):
    """Each case of the set against the jnp path of corner_subpix: median
    < 1e-4 px, max < 1e-2 px; the border case reaches the clip-shifted
    slice, the guard case the divergence guard, the interior case keeps its
    refinements, invalid slots stay where they are."""
    c, v, kind, ref, out, clipped, rejected = edge_set
    m = kind == case
    assert m.sum() >= 2
    d = np.linalg.norm(out[m] - ref[m], axis=1)
    assert np.median(d) < 1e-4, f"median {np.median(d)}"
    assert d.max() < 1e-2, f"max {d.max()}"
    moved = np.linalg.norm(out[m] - c[m], axis=1)
    if case == "border":
        assert clipped[m].sum() >= m.sum() // 3 and rejected[m].any()
    elif case == "guard":
        assert rejected[m].sum() >= m.sum() // 2 and not clipped[m].any()
    elif case == "interior":
        assert not rejected[m].any() and (moved > 0).all()
    else:
        assert not v[m].any()
        np.testing.assert_array_equal(out[m], c[m])
        np.testing.assert_array_equal(ref[m], c[m])


def test_subpix_plain_step_count(monkeypatch):
    """The plain version's step count is 0 for invalid slots, 1..20 for
    valid ones, and the step at which the corner stopped: with ITERS cut to
    a corner's count k its output is the 20-step output, with k - 1 it is
    not (unless k is 20)."""
    img, c, v, _ = chip_smoke.subpix_edge_set(H, W, seed=0)
    det_img = _img(seed=3)
    corners, _, valid = jfeat.detect_blockwise(
        jnp.asarray(det_img), jnp.ones((H, W)), jnp.zeros(4, jnp.int32),
        block_rows=2, block_cols=2, per_block=20, min_distance=9)
    for image, pts, ok in ((img, c, v), (det_img, np.asarray(corners, np.float32), np.asarray(valid))):
        args = (torch.tensor(image), torch.tensor(pts), torch.tensor(ok))
        steps = torch.zeros(len(pts), dtype=torch.int32)
        full = ksubpix.subpix_plain(*args, steps=steps)
        k_all = steps.numpy()
        assert (k_all[~ok] == 0).all() and ((k_all[ok] >= 1) & (k_all[ok] <= ksubpix.ITERS)).all()
        moved = (full != args[1]).any(dim=1).numpy()
        ks = sorted(set(k_all[ok].tolist()))
        assert len(ks) >= 2
        for k in ks:
            sel = ok & (k_all == k)
            monkeypatch.setattr(ksubpix, "ITERS", k)
            assert torch.equal(ksubpix.subpix_plain(*args)[sel], full[sel]), k
            if k < 20:
                monkeypatch.setattr(ksubpix, "ITERS", k - 1)
                early = ksubpix.subpix_plain(*args).numpy()
                diff = (early != full.numpy()).any(axis=1)
                assert diff[sel & moved].all(), k
        monkeypatch.setattr(ksubpix, "ITERS", 20)
