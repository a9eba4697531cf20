"""Port parity: one LK level (kernel K1's plain route) and bidirectional
pyramidal LK (ic_gvins_tpu_torch.vision.lk / ops.lk).

The level tracker is held against the JAX gather reference
``lk._track_level``, which defines the edge behaviour (edge padding, clip-
shifted windows, no block-edge cull); the pattern of test_pallas_lk.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_vision_kernels import shift_image, synth_image
from ic_gvins_tpu.vision import features, lk, pyramid
from ic_gvins_tpu_torch.convert import pyramid_from_numpy
from ic_gvins_tpu_torch.ops.lk import lk_level_plain
from ic_gvins_tpu_torch.vision import lk as tlk

torch.set_num_threads(1)
N = 128


def _interior_corners(img):
    corners, _, valid = features.detect_blockwise(
        jnp.asarray(img), jnp.ones(img.shape), jnp.zeros(4, jnp.int32),
        block_rows=2, block_cols=2, per_block=20, min_distance=9,
    )
    H, W = img.shape
    inb = ((corners[:, 0] > 25) & (corners[:, 0] < W - 25)
           & (corners[:, 1] > 25) & (corners[:, 1] < H - 25))
    pts = np.zeros((N, 2), np.float32)
    v = np.zeros(N, bool)
    pts[: corners.shape[0]] = np.asarray(corners)
    v[: corners.shape[0]] = np.asarray(valid & inb)
    return pts, v


def _both_levels(i0, i1, pts, guess, v):
    out_x, ok_x = lk._track_level(jnp.asarray(i0, jnp.float32), jnp.asarray(i1, jnp.float32),
                                  jnp.asarray(pts), jnp.asarray(guess), jnp.asarray(v))
    out_t, ok_t = lk_level_plain(torch.tensor(i0, dtype=torch.float32),
                                 torch.tensor(i1, dtype=torch.float32),
                                 torch.tensor(pts), torch.tensor(guess), torch.tensor(v))
    return np.asarray(out_x), np.asarray(ok_x), out_t.numpy(), ok_t.numpy()


def test_level_matches_track_level():
    """Median endpoint difference < 1e-3 px, median flow error < 0.1 px,
    identical ok flags."""
    img0 = synth_image(H=240, W=320, seed=7)
    dx, dy = 3.37, -2.21
    img1 = shift_image(img0, dx, dy)
    pts, v = _interior_corners(img0)
    out_x, ok_x, out_t, ok_t = _both_levels(img0, img1, pts, pts, v)

    np.testing.assert_array_equal(ok_t, ok_x)
    both = ok_t & ok_x
    assert both.sum() >= 20
    d = np.linalg.norm(out_t[both] - out_x[both], axis=1)
    assert np.median(d) < 1e-3, f"median endpoint diff {np.median(d)}"
    err = np.linalg.norm(out_t[both] - pts[both] - [dx, dy], axis=1)
    assert np.median(err) < 0.1, f"median flow err {np.median(err)}"


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_level_near_border_matches_track_level(sign):
    """Features 6-15 px from the edge, flowing toward it: windows leave the
    image, so the clip-shift rule of extract_patch decides the result."""
    H, W = 120, 160
    img0 = synth_image(H=H, W=W, seed=11, n_blobs=30)
    dx, dy = 7.3 * sign, 6.2 * sign
    img1 = shift_image(img0, dx, dy)
    rng = np.random.default_rng(4)
    m = 48
    dist = rng.uniform(6.0, 15.0, (m, 2))
    along = rng.uniform(20.0, [W - 20.0, H - 20.0], (m, 2))
    # first half near the x edge the flow points to, second half near the y edge
    near = np.where(sign > 0, [W - 1.0, H - 1.0] - dist, dist)
    pts_np = along.copy()
    pts_np[: m // 2, 0] = near[: m // 2, 0]
    pts_np[m // 2 :, 1] = near[m // 2 :, 1]
    pts = np.zeros((N, 2), np.float32)
    pts[:m] = pts_np
    v = np.zeros(N, bool)
    v[:m] = True
    guess = pts + np.asarray([dx, dy], np.float32) + rng.uniform(-0.4, 0.4, (N, 2)).astype(np.float32)
    out_x, ok_x, out_t, ok_t = _both_levels(img0, img1, pts, guess, v)

    # windows that reached past the image edge exist in this case
    assert ((out_x[:m] < 0) | (out_x[:m] > [W - 1, H - 1])).any()
    np.testing.assert_array_equal(ok_t, ok_x)
    both = ok_t & ok_x
    assert both.sum() >= m // 2
    d = np.linalg.norm(out_t[both] - out_x[both], axis=1)
    assert np.median(d) < 1e-3, f"median endpoint diff {np.median(d)}"


def test_track_bidirectional_matches_reference():
    """Interior features through 4 levels forward + backward, on the
    reference's own pyramids: same ok flags, endpoints within 1e-2 px median
    (the JAX CPU path tracks each level with its batched sandwich tracker,
    which sums in another order than the gather reference)."""
    img0 = synth_image(H=240, W=320, seed=3)
    dx, dy = 2.6, -1.4
    img1 = shift_image(img0, dx, dy)
    pyr0 = pyramid.build_pyramid(jnp.asarray(img0, jnp.float32), 4)
    pyr1 = pyramid.build_pyramid(jnp.asarray(img1, jnp.float32), 4)
    pts, v = _interior_corners(img0)

    fwd_x, ok_x = lk.track_bidirectional(pyr0, pyr1, jnp.asarray(pts), jnp.asarray(pts),
                                         jnp.asarray(v))
    levels0 = [np.array(a) for a in pyr0]
    t0 = pyramid_from_numpy(levels0)
    t1 = pyramid_from_numpy([np.asarray(a) for a in pyr1])
    levels0[0][:] = 0.0  # the port's pyramid is a copy, never a view of the host arrays
    assert float(t0[0].abs().max()) > 0 and all(a.is_contiguous() for a in t0)
    fwd_t, ok_t = tlk.track_bidirectional(t0, t1, torch.tensor(pts), torch.tensor(pts),
                                          torch.tensor(v))
    ok_x, ok_t = np.asarray(ok_x), ok_t.numpy()
    np.testing.assert_array_equal(ok_t, ok_x)
    assert ok_t.sum() >= 20
    d = np.linalg.norm(fwd_t.numpy()[ok_t] - np.asarray(fwd_x)[ok_t], axis=1)
    assert np.median(d) < 1e-2, f"median endpoint diff {np.median(d)}"
    err = np.linalg.norm(fwd_t.numpy()[ok_t] - pts[ok_t] - [dx, dy], axis=1)
    assert np.median(err) < 0.15, f"median flow err {np.median(err)}"
