"""A seeded data root served by both packages' apps (helper of the
``test_torch_*`` route tests).

Each package gets its own root with the same content: per video a small
mp4, its frames as JPEGs, metadata JSON with OCR text (some with Vietnamese
accents), objects, tags and captions, a transcript sidecar, and one
``.npy`` of frame embeddings, the JAX engine's encode of the decoded JPEGs,
written to both roots, so both indexes hold the same rows and an indexed
frame sent as a query image finds itself. ViT-Tiny-Test params are carried
across; both contexts keep their default Vietnamese preprocessor.
"""

from __future__ import annotations

import json

import numpy as np

VIDEOS = {"clipA": 24, "clipB": 9, "clipC": 13}
OCR = ["EXIT sign", "LỐI THOÁT", "Đường phố", "cấm vào"]
OBJECTS = ["car", "person", "dog"]
TAGS = ["night", "đám đông"]
CAPTIONS = ["a red car at night", "người đàn ông đang chạy"]
SPEECH = ["hãy chạy ra lối thoát", "the car is on fire", "xin chào"]


def frames_for(name: str, n: int, size: int, seed: int) -> np.ndarray:
    """Seeded uint8 RGB frames: a coloured block layout plus noise."""
    rng = np.random.default_rng(seed)
    blocks = rng.integers(0, 256, (n, 4, 4, 3)).repeat(size // 4, 1).repeat(size // 4, 2)
    noise = rng.integers(-12, 13, (n, size, size, 3))
    return np.clip(blocks + noise, 0, 255).astype(np.uint8)


def records_for(name: str, n: int, rng) -> list[dict]:
    def dets(pool, p):
        if rng.random() >= p:
            return []
        return [{"label": str(rng.choice(pool)), "confidence": float(np.round(rng.uniform(0.3, 1), 3)),
                 "bounding_box": [0, 0, 1, 1]}]

    return [{
        "id": f"{name}-{i}", "media_type": "image", "filepath": f"frames/{name}/{i * 5}.jpg",
        "tags": [str(rng.choice(TAGS))] if rng.random() < 0.3 else [],
        "metadata": {"caption": str(rng.choice(CAPTIONS))} if rng.random() < 0.3 else {},
        "video": f"videos/{name}.mp4", "frameid": f"{i * 5}.jpg", "frameidx": i * 5,
        "text_detections": {"detections": dets(OCR, 0.6)},
        "object_detections": {"detections": dets(OBJECTS, 0.5)},
    } for i in range(n)]


def write_roots(roots, jengine, size: int) -> dict:
    """Write the same videos into each ``DataRootConfig`` of ``roots``;
    returns {video: (jpeg paths in the first root, decoded RGB frames)}."""
    import cv2

    from evr_tpu_torch.index import VideoRegistry

    out = {}
    for v, (name, n) in enumerate(VIDEOS.items()):
        frames = frames_for(name, n, size, v)
        rng = np.random.default_rng(100 + v)
        records = records_for(name, n, rng)
        t, segments = 0.0, []
        for text in rng.choice(SPEECH, 4):
            segments.append({"start": t, "end": t + 1.5, "text": str(text)})
            t += 2.0
        decoded, paths, emb = [], [], None
        for k, root in enumerate(roots):
            root.ensure()
            frames_dir = root.frames_dir / name
            frames_dir.mkdir(parents=True, exist_ok=True)
            for i, f in enumerate(frames):
                path = frames_dir / f"{i * 5}.jpg"
                cv2.imwrite(str(path), np.ascontiguousarray(f[:, :, ::-1]))
                if k == 0:
                    paths.append(path)
                    decoded.append(cv2.imread(str(path))[:, :, ::-1])
            if emb is None:
                emb = jengine.encode_staged_images(np.stack(decoded))
            writer = cv2.VideoWriter(str(root.video_dir / f"{name}.mp4"),
                                     cv2.VideoWriter_fourcc(*"mp4v"), 10.0, (32, 32))
            for f in frames:
                writer.write(np.ascontiguousarray(f[:32, :32]))
            writer.release()
            np.save(root.embedding_dir / f"{name}_embeddings.npy", emb)
            (root.metadata_dir / f"{name}_metadata.json").write_text(
                json.dumps(records, ensure_ascii=False), encoding="utf-8")
            (root.metadata_dir / f"{name}_transcript.json").write_text(
                json.dumps({"segments": segments}, ensure_ascii=False), encoding="utf-8")
            VideoRegistry(root.mapping_path).add(
                name, metadata_file=f"metadata/{name}_metadata.json",
                embeddings_file=f"embedding/{name}_embeddings.npy",
                video_path=f"videos/{name}.mp4", frames_dir=f"frames/{name}",
                embedding_model="original",
            )
        out[name] = (paths, np.stack(decoded))
    return out


def build_pair(base, **ctx_kwargs):
    """(JAX client, port client, frames) over two fresh roots under ``base``."""
    import jax
    from werkzeug.test import Client

    from evr_tpu.config import DataRootConfig as JRoot
    from evr_tpu.index import EmbeddingEngine as JEngine
    from evr_tpu.models.clip import init_clip_params
    from evr_tpu.models.variants import get_model_config
    from evr_tpu.serving import ServingContext as JContext, create_app as jcreate_app
    from evr_tpu_torch.config import DataRootConfig as TRoot
    from evr_tpu_torch.index import EmbeddingEngine as TEngine
    from evr_tpu_torch.serving import ServingContext as TContext, create_app as tcreate_app

    cfg = get_model_config("ViT-Tiny-Test")
    params = jax.tree.map(np.asarray, init_clip_params(jax.random.PRNGKey(0), cfg))
    jengine = JEngine("ViT-Tiny-Test", params=params, cfg=cfg, batch_size=4)
    tengine = TEngine("ViT-Tiny-Test", params=params, batch_size=4, device="cpu")
    jroot, troot = JRoot(base / "jax"), TRoot(base / "torch")
    frames = write_roots([jroot, troot], jengine, cfg.vision.image_size)
    jctx = JContext(jroot, engine=jengine, **ctx_kwargs)
    tctx = TContext(troot, engine=tengine, **ctx_kwargs)
    assert jctx.boot() == tctx.boot() == list(VIDEOS)
    return Client(jcreate_app(jctx)), Client(tcreate_app(tctx)), frames


def payload(resp):
    return json.loads(resp.get_data(as_text=True))


def ids(events):
    return [(e.get("videoId"), e.get("id")) for e in events]


def same_events(got, ref, key, tol):
    """Equal event lists up to near-tie swaps: where two positions hold
    different frames, their ``key`` scores lie within ``tol``; every
    event's score fields within ``tol``, its other fields equal."""
    scored = ("clip_similarity", "confidence", "video_score", "total_score")
    assert len(got) == len(ref), (ids(got), ids(ref))
    for g, r in zip(got, ref):
        if ids([g]) != ids([r]):
            assert abs(g[key] - r[key]) <= tol, (key, ids([g]), ids([r]), g[key], r[key])
    by_id = dict(zip(ids(ref), ref))
    for i, g in zip(ids(got), got):
        r = by_id[i]
        assert set(g) == set(r), i
        for k, v in r.items():
            if k in scored:
                assert abs(g[k] - v) <= tol, (i, k, g[k], v)
            elif k == "chain":
                same_events(g[k], v, "clip_similarity", tol)
            else:
                assert g[k] == v, (i, k, g[k], v)
