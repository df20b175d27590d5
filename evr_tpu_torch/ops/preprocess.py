"""Host-side image staging, the exact-PIL host path, the device-side
preprocessing and the CLIP normalisation constants.

Counterpart of ``evr_tpu/ops/preprocess.py`` plus the cv2 stagers of
``evr_tpu/index/engine.py``:

- ``stage_array_fast`` / ``stage_image_fast``: cv2 shortest-side resize and
  centre crop to uint8 [S, S, 3] (the staged frames ``encode_staged_u8``
  takes; query images and PNG folders);
- ``load_image_host``: PIL bicubic resize, centre crop and normalisation, the
  exact reference-parity path (``EmbeddingEngine(preprocess_mode="pil")``);
- ``preprocess_batch`` / ``preprocess_for_model``: a uint8 or float batch
  resized on its device by the JAX package's antialiased cubic resize
  (``jax.image.resize(method="bicubic", antialias=True)``, built per axis by
  ``cubic_weight_mat``; ``F.interpolate`` computes another function), centre
  cropped and normalised.

The JPEG folders of ingest are staged by ``evr_tpu_torch.native``. cv2 and
PIL are imported inside the functions that use them.
"""

from __future__ import annotations

import numpy as np
import torch

from evr_tpu_torch.utils.device import resolve_device

# OpenAI CLIP normalisation constants
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel with a = −0.5, at distances x ≥ 0."""
    near = ((1.5 * x - 2.5) * x) * x + 1.0
    far = ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0
    return np.where(x >= 2.0, 0.0, np.where(x >= 1.0, far, near))


def cubic_weight_mat(n_in: int, n_out: int, dtype=np.float64) -> np.ndarray:
    """[n_in, n_out] weights of a cubic resize along one axis, as
    ``jax.image.resize(method="cubic")`` builds them: half-pixel centres, the
    kernel widened by the scale when downsampling (antialias), each output's
    weights divided by their sum over the inputs, and outputs whose sample
    lies outside [−0.5, n_in − 0.5] zeroed. ``F.interpolate(mode="bicubic")``
    differs (a = −0.75, indices clamped at the border). ``dtype=np.float32``
    repeats JAX's own float32 arithmetic step for step (image resizes);
    float64 is the exact weights."""
    dtype = np.dtype(dtype).type
    inv_scale = dtype(1.0 / (n_out / n_in))
    sample = (np.arange(n_out, dtype=dtype) + dtype(0.5)) * inv_scale - dtype(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=dtype)[:, None]) / max(inv_scale, dtype(1.0))
    w = _keys_cubic(x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, dtype(1.0)), dtype(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, dtype(0.0)).astype(dtype)


def preprocess_batch(images: torch.Tensor, image_size: int = 224) -> torch.Tensor:
    """uint8/float [B, H, W, 3] → normalised float32 [B, S, S, 3] on the
    images' device: the shortest side resized to ``image_size`` (cubic,
    antialiased on a downscale), the centre ``image_size``² crop, the CLIP
    normalisation. Only the cropped outputs are computed (each output of the
    separable resize depends on its own column of weights alone); an axis
    whose size does not change is not resampled, as in ``jax.image.resize``."""
    x = images.float() / 255.0 if images.dtype == torch.uint8 else images.float()
    _, H, W, _ = x.shape
    scale = image_size / min(H, W)
    new_h, new_w = int(round(H * scale)), int(round(W * scale))
    top, left = (new_h - image_size) // 2, (new_w - image_size) // 2

    def weights(n_in, n_out, start):
        w = cubic_weight_mat(n_in, n_out, np.float32)[:, start : start + image_size]
        return torch.from_numpy(np.ascontiguousarray(w)).to(x.device)

    if new_h != H:
        x = torch.einsum("bhwc,hi->biwc", x, weights(H, new_h, top))
    else:
        x = x[:, top : top + image_size]
    if new_w != W:
        x = torch.einsum("bhwc,wj->bhjc", x, weights(W, new_w, left))
    else:
        x = x[:, :, left : left + image_size]
    mean = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(CLIP_STD, dtype=torch.float32, device=x.device)
    return (x - mean) / std


def preprocess_for_model(images: np.ndarray, image_size: int = 224, device=None) -> torch.Tensor:
    """Host numpy batch → ``preprocess_batch`` on ``device`` (None: the
    card, raising without one; "cpu" on the CPU)."""
    x = torch.from_numpy(np.ascontiguousarray(images)).to(resolve_device(device))
    return preprocess_batch(x, image_size=image_size)


def load_image_host(path, image_size: int = 224) -> np.ndarray:
    """Exact reference-parity host path: PIL bicubic resize of the shortest
    side, centre crop, CLIP normalisation → float32 [S, S, 3]."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    w, h = img.size
    scale = image_size / min(w, h)
    img = img.resize((int(round(w * scale)), int(round(h * scale))), Image.BICUBIC)
    w, h = img.size
    left = (w - image_size) // 2
    top = (h - image_size) // 2
    img = img.crop((left, top, left + image_size, top + image_size))
    x = np.asarray(img, dtype=np.float32) / 255.0
    return (x - np.asarray(CLIP_MEAN, np.float32)) / np.asarray(CLIP_STD, np.float32)


def stage_array_fast(rgb: np.ndarray, image_size: int = 224) -> np.ndarray:
    """uint8 RGB array → shortest-side resize + centre crop, uint8 [S, S, 3]
    (INTER_AREA downscale, INTER_CUBIC upscale)."""
    import cv2

    h, w = rgb.shape[:2]
    scale = image_size / min(h, w)
    interp = cv2.INTER_AREA if scale < 1.0 else cv2.INTER_CUBIC
    img = cv2.resize(
        rgb, (int(round(w * scale)), int(round(h * scale))), interpolation=interp
    )
    h, w = img.shape[:2]
    top, left = (h - image_size) // 2, (w - image_size) // 2
    return np.ascontiguousarray(img[top : top + image_size, left : left + image_size])


def stage_image_fast(path, image_size: int = 224) -> np.ndarray:
    """cv2 decode + shortest-side resize + centre crop → uint8 [S, S, 3] RGB."""
    import cv2

    img = cv2.imread(str(path), cv2.IMREAD_COLOR)
    if img is None:
        raise IOError(f"cannot decode image: {path}")
    return stage_array_fast(np.ascontiguousarray(img[:, :, ::-1]), image_size)
