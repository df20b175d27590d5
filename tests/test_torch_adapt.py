"""The port's positional-embedding resample (``models/clip.py``'s
``interpolate_pos_embedding``, ``models/adapt.py``) against the JAX
package's, on the CPU.

The JAX package resamples with ``jax.image.resize(method="cubic")``: Keys'
kernel at a = −0.5, half-pixel centres, weights renormalised over the input,
antialiased when downsampling. The port must give the same grid within 1e-5;
``F.interpolate(mode="bicubic")`` (a = −0.75, clamped borders) must not.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from evr_tpu.models import clip as jclip
from evr_tpu.models.adapt import adapt_params_for_resolution as jadapt
from evr_tpu_torch.models import clip as tclip
from evr_tpu_torch.models import params_from_numpy
from evr_tpu_torch.models.adapt import adapt_params_for_resolution as tadapt

TOL = 1e-5
# (old grid, new grid): ViT-B/32 224 → 320, ViT-L/14 224 → 336, a downsample
GRIDS = [(7, 10), (16, 24), (8, 5)]


def pos_embedding(grid: int, width: int = 64, seed: int = 0) -> np.ndarray:
    # CLIP's scale: width^-1/2
    return (np.random.default_rng(seed).standard_normal((1 + grid * grid, width))
            * width ** -0.5).astype(np.float32)


@pytest.mark.parametrize("old, new", GRIDS)
def test_interpolate_pos_embedding_matches_jax(old, new):
    pos = pos_embedding(old)
    got = tclip.interpolate_pos_embedding(torch.from_numpy(pos), new)
    ref = np.asarray(jclip.interpolate_pos_embedding(pos, new))
    assert got.shape == ref.shape == (1 + new * new, pos.shape[1]) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=TOL)
    assert torch.equal(got[0], torch.from_numpy(pos[0]))  # the class position is kept


@pytest.mark.parametrize("old, new", GRIDS)
def test_f_interpolate_bicubic_misses_the_bound(old, new):
    """Negative control: torch's bicubic resize is another function."""
    pos = pos_embedding(old)
    grid = torch.from_numpy(pos[1:]).reshape(old, old, -1).permute(2, 0, 1)[None]
    other = torch.nn.functional.interpolate(grid, size=(new, new), mode="bicubic", align_corners=False)
    other = other[0].permute(1, 2, 0).reshape(new * new, -1).numpy()
    ref = np.asarray(jclip.interpolate_pos_embedding(pos, new))[1:]
    assert np.abs(other - ref).max() > 100 * TOL


def test_adapt_matches_jax_is_idempotent_and_serves():
    small = tclip.CLIPConfig(
        embed_dim=16,
        vision=tclip.VisionConfig(image_size=32, patch_size=8, width=32, layers=1, heads=2),
        text=tclip.TextConfig(16, 100, 32, 1, 2),
    )
    big = dataclasses.replace(small, vision=dataclasses.replace(small.vision, image_size=64))
    params = tclip.init_clip_params(0, small)
    adapted = tadapt(params, big)
    jbig = jclip.CLIPConfig(
        embed_dim=16,
        vision=jclip.VisionConfig(image_size=64, patch_size=8, width=32, layers=1, heads=2),
        text=jclip.TextConfig(16, 100, 32, 1, 2),
    )
    ref = jadapt(params, jbig)
    np.testing.assert_allclose(adapted["visual"]["pos_embedding"].numpy(),
                               np.asarray(ref["visual"]["pos_embedding"]), rtol=0, atol=TOL)
    assert adapted["visual"]["blocks"] is params["visual"]["blocks"]  # only the grid is new
    assert tadapt(adapted, big) is adapted  # the grid fits: nothing to do
    pixels = np.random.default_rng(1).normal(size=(2, 64, 64, 3)).astype(np.float32)
    got = tclip.encode_image(params_from_numpy(adapted), big, torch.from_numpy(pixels))
    want = np.asarray(jclip.encode_image(jax.tree.map(np.asarray, ref), jbig, pixels))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-4)  # the fp32 encode bound
