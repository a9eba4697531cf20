"""Port parity: one LK level, the fused pyramidal track (kernel K1's plain
route) and bidirectional pyramidal LK (ic_gvins_tpu_torch.vision.lk /
ops.lk).

The level tracker is held against the JAX gather reference
``lk._track_level``, which defines the edge behaviour (edge padding, clip-
shifted windows, no block-edge cull); the pattern of test_pallas_lk.py. The
fused track is held against a cascade of ``_track_level`` composed here as
``pyr_lk`` / ``track_bidirectional`` compose their level tracker: the JAX
package's own entry points take the batched tracker with its block cull."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_harness import jax_compile_cache  # noqa: F401 (autouse: the run's compile cache)
from test_vision_kernels import shift_image, synth_image
from ic_gvins_tpu.vision import features, lk, pyramid
from ic_gvins_tpu_torch.convert import pyramid_from_numpy
from ic_gvins_tpu_torch.ops.lk import lk_level_plain, lk_pyr_plain
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
    t0 = pyramid_from_numpy(levels0, device="cpu")
    t1 = pyramid_from_numpy([np.asarray(a) for a in pyr1], device="cpu")
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


_jax_level = jax.jit(lk._track_level)


def _jax_cascade(pyr_prev, pyr_next, pts_prev, pts_init, valid, levels=4):
    """pyr_lk's composition over the gather reference level tracker."""
    guess = pts_init / 2.0 ** (levels - 1)
    status = valid
    for lvl in range(levels - 1, -1, -1):
        guess, ok = _jax_level(pyr_prev[lvl], pyr_next[lvl], pts_prev / 2.0**lvl, guess, valid)
        status = status & ok
        if lvl > 0:
            guess = guess * 2.0
    H, W = pyr_next[0].shape
    inb = (guess[:, 0] >= 0) & (guess[:, 0] <= W - 1) & (guess[:, 1] >= 0) & (guess[:, 1] <= H - 1)
    return guess, status & inb


def _jax_track(pyr_prev, pyr_next, pts_prev, pts_pred, valid, directions):
    """track_bidirectional's composition (fb 0.5 px, border 5 px)."""
    fwd, st_f = _jax_cascade(pyr_prev, pyr_next, pts_prev, pts_pred, valid)
    if directions == 1:
        return fwd, st_f
    bwd, st_b = _jax_cascade(pyr_next, pyr_prev, fwd, pts_prev, valid & st_f)
    H, W = pyr_next[0].shape
    dist = jnp.linalg.norm(bwd - pts_prev, axis=-1)
    on_border = (fwd[:, 0] < 5) | (fwd[:, 1] < 5) | (fwd[:, 0] > W - 5) | (fwd[:, 1] > H - 5)
    return fwd, st_f & st_b & (dist < 0.5) & ~on_border & valid


def _near_border_case(sign, H=120, W=160):
    """Features 6-15 px from the edge the flow points to (half near the x
    edge, half near the y edge), guesses within 0.4 px of the true flow."""
    img0 = synth_image(H=H, W=W, seed=11, n_blobs=30)
    dx, dy = 7.3 * sign, 6.2 * sign
    img1 = shift_image(img0, dx, dy)
    rng = np.random.default_rng(4)
    m = 48
    dist = rng.uniform(6.0, 15.0, (m, 2))
    pts_np = rng.uniform(20.0, [W - 20.0, H - 20.0], (m, 2))
    near = np.where(sign > 0, [W - 1.0, H - 1.0] - dist, dist)
    pts_np[: m // 2, 0] = near[: m // 2, 0]
    pts_np[m // 2 :, 1] = near[m // 2 :, 1]
    pts = np.zeros((N, 2), np.float32)
    pts[:m] = pts_np
    v = np.zeros(N, bool)
    v[:m] = True
    guess = pts + np.asarray([dx, dy], np.float32) + rng.uniform(-0.4, 0.4, (N, 2)).astype(np.float32)
    return img0, img1, pts, guess, v


def _interior_case():
    img0 = synth_image(H=240, W=320, seed=3)
    img1 = shift_image(img0, 2.6, -1.4)
    pts, v = _interior_corners(img0)
    guess = pts + np.asarray([2.0, -1.0], np.float32)
    return img0, img1, pts, guess, v


@pytest.mark.parametrize("directions", [1, 2])
@pytest.mark.parametrize("case", ["interior", "border+", "border-"])
def test_lk_pyr_plain_matches_track_level_cascade(case, directions):
    """The fused track's plain version against the reference's level tracker
    composed as pyr_lk (1 direction) or track_bidirectional (2): identical
    ok flags, median endpoint difference < 1e-3 px over the ok slots."""
    if case == "interior":
        img0, img1, pts, guess, v = _interior_case()
    else:
        img0, img1, pts, guess, v = _near_border_case(1.0 if case == "border+" else -1.0)
    pyr0 = pyramid.build_pyramid(jnp.asarray(img0, jnp.float32), 4)
    pyr1 = pyramid.build_pyramid(jnp.asarray(img1, jnp.float32), 4)
    fwd_x, ok_x = _jax_track(pyr0, pyr1, jnp.asarray(pts), jnp.asarray(guess), jnp.asarray(v),
                             directions)
    t0 = pyramid_from_numpy([np.asarray(a) for a in pyr0], device="cpu")
    t1 = pyramid_from_numpy([np.asarray(a) for a in pyr1], device="cpu")
    fwd_t, ok_t = lk_pyr_plain(t0, t1, torch.tensor(pts), torch.tensor(guess), torch.tensor(v),
                               directions=directions)
    fwd_x, ok_x, fwd_t, ok_t = np.asarray(fwd_x), np.asarray(ok_x), fwd_t.numpy(), ok_t.numpy()

    np.testing.assert_array_equal(ok_t, ok_x)
    assert ok_t.sum() >= 8, int(ok_t.sum())  # near the border most tracks leave the image
    d = np.linalg.norm(fwd_t[ok_t] - fwd_x[ok_t], axis=1)
    assert np.median(d) < 1e-3, f"median endpoint diff {np.median(d)}"
    if case != "interior":
        # the flow carries windows past the image edge: the clip-shift path ran
        H, W = img0.shape
        assert ((fwd_x[v] < 0) | (fwd_x[v] > [W - 1, H - 1])).any()


def test_vision_entry_points_are_the_fused_track():
    """pyr_lk and track_bidirectional are lk_pyr with 1 and 2 directions."""
    img0, img1, pts, guess, v = _near_border_case(1.0)
    t0 = pyramid_from_numpy(pyramid.build_pyramid(jnp.asarray(img0, jnp.float32), 4), device="cpu")
    t1 = pyramid_from_numpy(pyramid.build_pyramid(jnp.asarray(img1, jnp.float32), 4), device="cpu")
    args = (t0, t1, torch.tensor(pts), torch.tensor(guess), torch.tensor(v))
    for got, want in ((tlk.pyr_lk(*args), lk_pyr_plain(*args, directions=1)),
                      (tlk.track_bidirectional(*args), lk_pyr_plain(*args, directions=2))):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
