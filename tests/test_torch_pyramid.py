"""Port parity: CLAHE and the Gaussian pyramid (ic_gvins_tpu_torch.vision.pyramid).

The same numpy images go through the JAX reference (CPU branch of
``pyramid.clahe``, the jnp fallback of the CLAHE apply) and the port's plain
PyTorch path (the CPU route of kernel K3)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_harness import jax_compile_cache  # noqa: F401 (autouse: the run's compile cache)
from test_vision_kernels import synth_image
from ic_gvins_tpu.vision import pyramid as jpyr
from ic_gvins_tpu_torch.vision import pyramid as tpyr

torch.set_num_threads(1)


def _images():
    rng = np.random.default_rng(7)
    return {
        "synth_240x320": synth_image(H=240, W=320, seed=7),
        "uniform_96x130": rng.uniform(0, 255, (96, 130)),
        "flat_noise_128": np.clip(100.0 + 8.0 * rng.standard_normal((128, 128)), 0, 255),
    }


@pytest.mark.parametrize("name", sorted(_images()))
def test_clahe_matches_reference(name):
    """99.9 % of pixels within 1e-3 gray and none beyond 1.0 gray: one bf16
    step of the LUT near 255, which a CDF summed in another order can flip."""
    img = _images()[name]
    ref = np.asarray(jpyr.clahe(jnp.asarray(img)))
    out = tpyr.clahe(torch.tensor(img)).numpy()
    assert out.shape == ref.shape and out.dtype == np.float32
    d = np.abs(out - ref)
    assert (d <= 1e-3).mean() >= 0.999, f"{(d > 1e-3).mean():.2e} of pixels beyond 1e-3"
    assert d.max() <= 1.0, f"max diff {d.max()}"


@pytest.mark.parametrize("shape", [(240, 320), (121, 77)])
def test_pyr_down_and_build_pyramid(shape):
    """cv::pyrDown 5-tap blur + decimation, odd sizes included: <= 1e-4 abs."""
    img = synth_image(H=shape[0], W=shape[1], seed=3).astype(np.float32)
    ref = [np.asarray(a) for a in jpyr.build_pyramid(jnp.asarray(img), 4)]
    out = [a.numpy() for a in tpyr.build_pyramid(torch.tensor(img), 4)]
    for r, o in zip(ref, out):
        assert r.shape == o.shape
        np.testing.assert_allclose(o, r, rtol=0, atol=1e-4)
    np.testing.assert_allclose(tpyr.pyr_down(torch.tensor(img)).numpy(),
                               np.asarray(jpyr.pyr_down(jnp.asarray(img))), rtol=0, atol=1e-4)


def test_bilinear_sample_and_extract_patch():
    """Edge-clamped sampling and clip-shifted patches, border centers included."""
    img = synth_image(H=60, W=80, seed=5).astype(np.float32)
    rng = np.random.default_rng(2)
    xy = np.concatenate([rng.uniform(-3, 83, (40, 2)), [[0.2, 0.7], [78.6, 58.9], [2.5, 57.1]]])
    xy = xy.astype(np.float32)
    ref = np.asarray(jpyr.bilinear_sample(jnp.asarray(img), jnp.asarray(xy)))
    out = tpyr.bilinear_sample(torch.tensor(img), torch.tensor(xy)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)

    centers = np.clip(xy, 0.0, 79.0)
    for half in (6, 11):
        ref = np.stack([np.asarray(jpyr.extract_patch(jnp.asarray(img), jnp.asarray(c), half))
                        for c in centers])
        out = tpyr.extract_patch(torch.tensor(img), torch.tensor(centers), half).numpy()
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)
