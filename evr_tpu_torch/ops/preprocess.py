"""Host-side image staging and the CLIP normalisation constants.

Counterpart of the parts of ``evr_tpu/ops/preprocess.py`` and
``evr_tpu/index/engine.py`` the serving path uses: cv2 shortest-side resize
plus centre crop to uint8 [S, S, 3] (the staged frames ``encode_staged_u8``
takes). cv2 is imported inside the functions that use it; the exact-PIL
host path for parity evaluation is not ported yet.
"""

from __future__ import annotations

import numpy as np

# OpenAI CLIP normalisation constants
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


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

