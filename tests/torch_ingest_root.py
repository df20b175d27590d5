"""Shared inputs of the port's ingest tests: seeded ViT-Tiny-Test params,
twin engines (the JAX package's and the port's, fp32 on the CPU), JPEG
frames and cv2-written videos with hard scene changes."""

import numpy as np

MODEL = "ViT-Tiny-Test"
ATOL = 2e-4  # the fp32 encode bound of the port's engine tests


def tiny_params(seed: int = 1):
    import jax

    from evr_tpu.models.clip import init_clip_params
    from evr_tpu.models.variants import get_model_config

    cfg = get_model_config(MODEL)
    return jax.tree.map(np.asarray, init_clip_params(jax.random.PRNGKey(seed), cfg))


def twin_engines(params, batch_size: int = 4, **kwargs):
    from evr_tpu.index import EmbeddingEngine as JEngine
    from evr_tpu.models.variants import get_model_config
    from evr_tpu_torch.index import EmbeddingEngine as TEngine

    j = JEngine(MODEL, params=params, cfg=get_model_config(MODEL), batch_size=batch_size, **kwargs)
    t = TEngine(MODEL, params=params, batch_size=batch_size, device="cpu", **kwargs)
    return j, t


def textured(h: int, w: int, seed: int) -> np.ndarray:
    """A smooth seeded RGB pattern with noise (JPEG-like content)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    f = 12 + 6 * rng.random(3)
    img = np.stack([
        127 + 110 * np.sin(xx / f[0] + rng.random() * 6),
        127 + 110 * np.cos(yy / f[1] + rng.random() * 6),
        (xx + yy * f[2]) % 256,
    ], axis=-1)
    img += rng.normal(0, 12, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def write_video(path, n_frames: int = 60, size=(96, 64), fps: float = 25.0, seed: int = 0,
                scene_len=(18, 30)):
    """An mp4v video whose content jumps to a new flat colour every
    ``scene_len`` frames (a hard cut each time). Returns the cut frames."""
    import cv2

    rng = np.random.default_rng(seed)
    w, h = size
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    cuts, colour, left = [], rng.integers(0, 256, 3), 0
    for i in range(n_frames):
        if left == 0:
            if i:
                cuts.append(i)
            colour, left = rng.integers(0, 256, 3), int(rng.integers(*scene_len))
        frame = np.empty((h, w, 3), np.uint8)
        frame[:] = colour
        frame[h // 4 : h // 2, w // 4 : w // 2] = 255 - colour  # an object per scene
        writer.write(frame)
        left -= 1
    writer.release()
    return cuts
