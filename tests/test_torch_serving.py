"""The PyTorch port's HTTP API against the JAX package's, end to end.

One data root per package with the same videos, metadata and registry;
each holds the frame embeddings its own engine computed from the same frames
with the same (carried-over) ViT-Tiny-Test params. Both apps answer the same
requests through ``werkzeug.test.Client``; the port's payloads must equal the
JAX app's: the same events in the same order, and ``clip_similarity`` (and
the confidence fused from it) within 2e-4, the fp32 bound of the encode.
"""

import json

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
pytest.importorskip("werkzeug")

import jax
from werkzeug.test import Client

from evr_tpu.config import DataRootConfig as JRoot
from evr_tpu.index import EmbeddingEngine as JEngine
from evr_tpu.models.clip import init_clip_params
from evr_tpu.models.variants import get_model_config
from evr_tpu.query.text import identity_preprocessor
from evr_tpu.serving import ServingContext as JContext, create_app as jcreate_app
from evr_tpu_torch.config import DataRootConfig as TRoot
from evr_tpu_torch.index import EmbeddingEngine as TEngine
from evr_tpu_torch.serving import ServingContext as TContext, create_app as tcreate_app

SCORE_TOL = 2e-4
VIDEOS = {"clipA": 9, "clipB": 6, "clipC": 7}


def _frames(n, seed, size):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3), dtype=np.uint8)


def _write_root(root, engine, frames_by_video):
    root.ensure()
    from evr_tpu.index import VideoRegistry

    reg = VideoRegistry(root.mapping_path)
    for v, (name, frames) in enumerate(frames_by_video.items()):
        writer = cv2.VideoWriter(str(root.video_dir / f"{name}.mp4"),
                                 cv2.VideoWriter_fourcc(*"mp4v"), 10.0, (32, 32))
        for f in frames:
            writer.write(np.ascontiguousarray(f[:32, :32]))
        writer.release()
        emb = engine.encode_staged_images(frames)
        np.save(root.embedding_dir / f"{name}_embeddings.npy", emb)
        records = [
            {
                "id": f"{name}-{i}", "media_type": "image",
                "filepath": f"frames/{name}/{i * 10}.jpg", "tags": [],
                "metadata": {}, "video": f"videos/{name}.mp4",
                "frameid": f"{i * 10}.jpg", "frameidx": i * 10,
                "text_detections": {"detections": (
                    [{"label": "EXIT sign", "confidence": 0.55}] if i % 3 == 0 else []
                )},
                "object_detections": {"detections": (
                    [{"label": "car", "confidence": 0.62}] if i % 4 == 1 else []
                )},
            }
            for i in range(len(frames))
        ]
        (root.metadata_dir / f"{name}_metadata.json").write_text(json.dumps(records))
        reg.add(
            name, metadata_file=f"metadata/{name}_metadata.json",
            embeddings_file=f"embedding/{name}_embeddings.npy",
            video_path=f"videos/{name}.mp4", embedding_model="original",
        )


@pytest.fixture(scope="module")
def clients(tmp_path_factory):
    cfg = get_model_config("ViT-Tiny-Test")
    params = jax.tree.map(np.asarray, init_clip_params(jax.random.PRNGKey(0), cfg))
    size = cfg.vision.image_size
    frames = {name: _frames(n, i, size) for i, (name, n) in enumerate(VIDEOS.items())}

    jengine = JEngine("ViT-Tiny-Test", params=params, cfg=cfg, batch_size=4)
    tengine = TEngine("ViT-Tiny-Test", params=params, batch_size=4, device="cpu")
    base = tmp_path_factory.mktemp("serving_parity")
    jroot, troot = JRoot(base / "jax"), TRoot(base / "torch")
    _write_root(jroot, jengine, frames)
    _write_root(troot, tengine, frames)

    jctx = JContext(jroot, engine=jengine, preprocessor=identity_preprocessor)
    tctx = TContext(troot, engine=tengine)
    assert jctx.boot() == tctx.boot() == list(VIDEOS)
    return Client(jcreate_app(jctx)), Client(tcreate_app(tctx))


def _payload(resp):
    return json.loads(resp.get_data(as_text=True))


def _same_events(got, ref):
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        assert (g["videoId"], g["id"]) == (r["videoId"], r["id"])
        assert set(g) == set(r)
        for key in r:
            if key in ("clip_similarity", "confidence"):
                assert abs(g[key] - r[key]) <= SCORE_TOL, (key, g[key], r[key])
            else:
                assert g[key] == r[key], key


def test_health_and_videos_match(clients):
    jc, tc = clients
    assert _payload(tc.get("/health")) == _payload(jc.get("/health")) == {"status": "ok"}
    jv, tv = _payload(jc.get("/api/videos")), _payload(tc.get("/api/videos"))
    assert [v["id"] for v in tv] == ["video-1", "video-2", "video-3"]
    assert tv == jv


SEARCHES = [
    {"search_method": "text_clip", "query": "a red car", "top_k": 5},
    {"search_method": "text_clip", "query": "a red car", "top_k": 4, "videoId": "video-2"},
    {"search_method": "text_adaptive", "query": "people walking", "top_k": 6,
     "adaptive_threshold": -1.0},
    {"search_method": "text_adaptive", "query": "people walking", "top_k": 3,
     "adaptive_threshold": -1.0, "videoId": "video-3"},
    {"query": "an exit sign", "top_k": 5, "adaptive_threshold": -1.0},  # "text" → adaptive
    {"search_method": "text_clip", "query": "a dog", "top_k": 5, "mmr_lambda": 0.5},
    {"search_method": "text_clip", "query": "a dog", "top_k": 5, "negative_query": "a cat"},
]


@pytest.mark.parametrize("body", SEARCHES, ids=lambda b: f"{b.get('search_method', 'text')}-{b.get('videoId', 'all')}-{b['top_k']}")
def test_search_payloads_match(clients, body):
    jc, tc = clients
    jr = jc.post("/api/search", json={"search_type": "text", **body})
    tr = tc.post("/api/search", json={"search_type": "text", **body})
    assert tr.status_code == jr.status_code == 200
    _same_events(_payload(tr)["events"], _payload(jr)["events"])


def test_adaptive_threshold_filters_like_jax(clients):
    jc, tc = clients
    body = {"search_type": "text", "search_method": "text_clip", "query": "a boat", "top_k": 20}
    scores = sorted(e["clip_similarity"] for e in _payload(tc.post("/api/search", json=body))["events"])
    mid = float(np.mean(scores[len(scores) // 2 - 1 : len(scores) // 2 + 1]))
    body.update(search_method="text_adaptive", adaptive_threshold=mid)
    ref = _payload(jc.post("/api/search", json=body))["events"]
    got = _payload(tc.post("/api/search", json=body))["events"]
    _same_events(got, ref)
    assert all(e["clip_similarity"] >= mid for e in got)
