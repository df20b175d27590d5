"""The exact-PIL host path, the device-side preprocessing and the "pil"
engine of the port against the JAX package's, on the CPU.

``load_image_host`` is the same PIL code: bit-equal. ``preprocess_batch`` is
JAX's antialiased cubic resize (``jax.image.resize``) built per axis by
``cubic_weight_mat`` in JAX's float32 arithmetic: within 1e-5 at up- and
downscales. The "pil" engine encodes float pixels through ``encode_image``:
within the fp32 encode bound of JAX's.
"""

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

import jax
import jax.numpy as jnp
from PIL import Image

from evr_tpu.ops.preprocess import load_image_host as jload, preprocess_batch as jpreprocess
from evr_tpu_torch.ops import load_image_host, preprocess_batch, preprocess_for_model
from evr_tpu_torch.ops.preprocess import cubic_weight_mat
from torch_ingest_root import ATOL, textured, tiny_params, twin_engines

PIXEL_TOL = 1e-5


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    d = tmp_path_factory.mktemp("pil")
    paths = []
    for i, (h, w) in enumerate([(90, 160), (48, 40), (64, 64), (300, 200)]):
        p = d / f"{i}.{'png' if i % 2 else 'jpg'}"
        Image.fromarray(textured(h, w, 30 + i)).save(p)
        paths.append(p)
    Image.fromarray(textured(70, 50, 40)).convert("RGBA").save(d / "4.png")
    return paths + [d / "4.png"]


@pytest.mark.parametrize("size", [224, 64])
def test_load_image_host_bit_equal(images, size):
    for p in images:
        got, ref = load_image_host(p, size), jload(p, size)
        assert got.shape == (size, size, 3) and got.dtype == np.float32
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("shape", [
    (2, 40, 70, 3), (2, 20, 30, 3), (1, 64, 64, 3), (1, 50, 32, 3), (1, 720, 1280, 3),
])
def test_preprocess_batch_matches_jax(shape):
    size = 224 if shape[1] >= 224 else 32
    x = np.random.default_rng(sum(shape)).integers(0, 256, shape, dtype=np.uint8)
    for batch in (x, x.astype(np.float32) / 255.0):
        got = preprocess_batch(torch.from_numpy(batch), size).numpy()
        ref = np.asarray(jpreprocess(jnp.asarray(batch), image_size=size))
        assert got.shape == ref.shape == (shape[0], size, size, 3)
        np.testing.assert_allclose(got, ref, rtol=0, atol=PIXEL_TOL)


def test_cubic_weights_repeat_jax_float32_arithmetic():
    from jax._src.image import scale

    kernel = scale._kernels[scale.ResizeMethod.CUBIC]
    for m, n in [(360, 224), (20, 32)]:
        ref = np.asarray(scale.compute_weight_mat(m, n, n / m, 0.0, kernel, True))
        got = cubic_weight_mat(m, n, np.float32)
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-7)


def test_preprocess_for_model_runs_where_asked():
    x = np.random.default_rng(0).integers(0, 256, (1, 48, 64, 3), dtype=np.uint8)
    got = preprocess_for_model(x, 32, device="cpu")
    assert got.device.type == "cpu" and got.dtype == torch.float32
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            preprocess_for_model(x, 32)


@pytest.fixture(scope="module")
def pil_engines():
    return twin_engines(tiny_params(2), preprocess_mode="pil")


def test_pil_engine_folder_and_files_match_jax(pil_engines, images):
    j, t = pil_engines
    folder = images[0].parent
    got, names = t.embed_folder(folder)
    ref, ref_names = j.embed_folder(folder)
    assert names == ref_names == sorted(p.name for p in images)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    got = t.encode_image_files(images[:3], normalise=True)
    np.testing.assert_allclose(got, j.encode_image_files(images[:3], normalise=True), rtol=0, atol=ATOL)


def test_fast_engine_image_files_match_jax(images):
    j, t = twin_engines(tiny_params(2))
    got = t.encode_image_files(images, normalise=True)
    np.testing.assert_allclose(got, j.encode_image_files(images, normalise=True), rtol=0, atol=ATOL)
    pixels = np.stack([load_image_host(p, 64) for p in images])
    np.testing.assert_allclose(t.encode_pixels(pixels), np.asarray(j._encode_array(pixels)),
                               rtol=0, atol=ATOL)
