"""The port's ``SiglipEngine`` and a SigLIP-served app against the JAX
package's (``tests/test_siglip.py``'s engine tests): features, staging,
``embed_folder``, the search routes (text, image, hybrid, models), the
upload route and the serving CLI with ``--model-family siglip``.

JAX's tiny SigLIP geometry, its params carried across, both on the CPU.
Tolerances: fp32 features atol 2e-4 and row cosine ≥ 0.99999; int8 5e-3;
staged pixels and tokenizer ids equal; search scores within 2e-4.
"""

import base64
import io
import sys

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
pytest.importorskip("werkzeug")

import jax

from evr_tpu.index.siglip_engine import SiglipEngine as JEngine
from evr_tpu.models import siglip as js
from evr_tpu_torch.index.siglip_engine import SiglipEngine as TEngine
from evr_tpu_torch.models import siglip as ts
from torch_ingest_root import write_video
from torch_route_root import VIDEOS, payload, same_events, write_roots

ATOL = 2e-4
MIN_COS = 0.99999
INT8_TOL = 5e-3


def _cfg(mod):
    return mod.SiglipConfig(
        vision=mod.SiglipVisionConfig(image_size=32, patch_size=16, width=32, layers=1, heads=2, mlp_dim=64),
        text=mod.SiglipTextConfig(context_length=8, vocab_size=50, width=32, layers=1, heads=2, mlp_dim=64),
    )


@pytest.fixture(scope="module")
def params():
    return jax.tree.map(np.asarray, js.init_siglip_params(jax.random.PRNGKey(0), _cfg(js)))


def _engines(params, **kw):
    return (JEngine(cfg=_cfg(js), params=params, batch_size=4, **kw),
            TEngine(cfg=_cfg(ts), params=params, batch_size=4, device="cpu", **kw))


def _close(got, ref, atol=ATOL, min_cos=MIN_COS):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)
    cos = (got * ref).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(ref, axis=-1))
    assert cos.min() >= min_cos, cos.min()


def test_engine_features_match_jax(params):
    j, t = _engines(params)
    assert (t.tokenizer_source, t.model_name, t.active_model) == (j.tokenizer_source, "siglip", "original")
    assert t.cfg.embed_dim == j.cfg.embed_dim and t.available_models() == j.available_models()
    staged = np.random.default_rng(0).integers(0, 256, (6, 32, 32, 3), dtype=np.uint8)  # odd tail batch
    got = t.encode_staged_images(staged)
    assert got.dtype == np.float32
    _close(got, j.encode_staged_images(staged))
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-5)
    texts = ["a dog running", "Người đàn ông", ""]
    _close(t.encode_texts(texts), j.encode_texts(texts))
    f = t.get_text_features("a dog running")
    assert t.get_text_features("a dog running") is f  # cached
    assert t.encode_staged_images(staged[:0]).shape == (0, 32)


def test_params_dtypes_match_jax(params):
    """int8 (the block linears) within 5e-3 of JAX's int8 engine; bfloat16
    params (every floating leaf cast, fp32 compute on the CPU) at fp32's
    bound of JAX's bfloat16 engine."""
    staged = np.random.default_rng(1).integers(0, 256, (5, 32, 32, 3), dtype=np.uint8)
    texts = ["a red car", "night street"]
    for dtype, atol, min_cos in (("int8", INT8_TOL, 0.9999), ("bfloat16", ATOL, MIN_COS)):
        j, t = _engines(params, params_dtype=dtype)
        assert t.params_dtype == dtype
        _close(t.encode_staged_images(staged), j.encode_staged_images(staged), atol, min_cos)
        _close(t.encode_texts(texts), j.encode_texts(texts), atol, min_cos)
    with pytest.raises(ValueError, match="params_dtype"):
        TEngine(cfg=_cfg(ts), params=params, device="cpu", params_dtype="fp8")


def test_stage_array_and_embed_folder_match_jax(params, tmp_path):
    j, t = _engines(params)
    rng = np.random.default_rng(3)
    tall = rng.integers(0, 256, (64, 20, 3), dtype=np.uint8)
    np.testing.assert_array_equal(t.stage_array(tall), j.stage_array(tall))
    assert t.stage_array(tall).shape == (32, 32, 3)
    for i in range(3):
        cv2.imwrite(str(tmp_path / f"{i}.jpg"), rng.integers(0, 256, (40, 40, 3), dtype=np.uint8))
    (tmp_path / "broken.jpg").write_bytes(b"not a jpeg")
    seen = []
    feats, names = t.embed_folder(tmp_path, progress=lambda i, n: seen.append((i, n)))
    jfeats, jnames = j.embed_folder(tmp_path)
    assert names == jnames == ["0.jpg", "1.jpg", "2.jpg"] and seen == [(1, 4), (2, 4), (3, 4)]
    _close(feats, jfeats)


@pytest.fixture(scope="module")
def clients(tmp_path_factory, params):
    from werkzeug.test import Client

    from evr_tpu.config import DataRootConfig as JRoot
    from evr_tpu.serving import ServingContext as JContext, create_app as jcreate_app
    from evr_tpu_torch.config import DataRootConfig as TRoot
    from evr_tpu_torch.serving import ServingContext as TContext, create_app as tcreate_app

    base = tmp_path_factory.mktemp("siglip_routes")
    j, t = _engines(params)
    jroot, troot = JRoot(base / "jax"), TRoot(base / "torch")
    frames = write_roots([jroot, troot], j, 32)
    jctx, tctx = JContext(jroot, engine=j), TContext(troot, engine=t)
    assert jctx.boot() == tctx.boot() == list(VIDEOS)
    return Client(jcreate_app(jctx)), Client(tcreate_app(tctx)), frames


def _search(clients, body):
    jr, tr = (c.post("/api/search", json=body) for c in clients[:2])
    assert tr.status_code == jr.status_code == 200, tr.get_data(as_text=True)
    return payload(tr)["events"], payload(jr)["events"]


def _png(frame) -> str:
    ok, buf = cv2.imencode(".png", np.ascontiguousarray(frame[:, :, ::-1]))
    assert ok
    return "data:image/png;base64," + base64.b64encode(buf.tobytes()).decode()


def test_text_searches_match_jax(clients):
    """The two-step strategies over a SigLIP engine (no one-call searcher)."""
    assert clients[1].application.ctx.query_engine._searcher is None
    for body in ({"search_method": "text_clip", "query": "a red car", "top_k": 5},
                 {"search_method": "text", "query": "người đàn ông", "top_k": 5},
                 {"search_method": "text_speech", "query": "the car is on fire", "top_k": 5},
                 {"search_method": "video", "query": "a red car", "top_k": 3}):
        got, ref = _search(clients, {**body, "adaptive_threshold": -1.0})
        assert got, body
        key = "video_score" if body["search_method"] == "video" else "confidence"
        same_events(got, ref, key if key in ref[0] else "clip_similarity", ATOL)


def test_image_and_hybrid_search_match_jax(clients, monkeypatch):
    """A query image staged by the engine's squash (not CLIP's crop): an
    indexed frame finds itself first; hybrid blends with the text.

    The JAX app answers every SigLIP hybrid request 400: its
    ``search_hybrid`` divides the engine's cached text features in place,
    and the JAX SigLIP engine caches read-only arrays. The port computes
    the blend out of place; it is held to the JAX app with the JAX engine's
    cache handing out writable copies."""
    frames = clients[2]["clipB"][1]
    query = np.ascontiguousarray(np.pad(frames[4], ((0, 0), (8, 8), (0, 0)), mode="edge"))  # 32 x 48
    hybrid = {"search_type": "hybrid", "image_url": _png(query), "top_k": 3, "adaptive_threshold": -1.0,
              "query": "a red car", "image_weight": 0.7}
    jr, tr = (c.post("/api/search", json=hybrid) for c in clients[:2])
    assert (jr.status_code, tr.status_code) == (400, 200) and "read-only" in jr.get_data(as_text=True)
    jengine = clients[0].application.ctx.engine
    cached = jengine.get_text_features
    monkeypatch.setattr(jengine, "get_text_features", lambda q: np.array(cached(q)))
    for extra in ({}, {"query": "a fire truck", "image_weight": 0.7}):
        body = {"search_type": "hybrid" if extra else "image", "image_url": _png(query), "top_k": 3,
                "adaptive_threshold": -1.0, **extra}
        got, ref = _search(clients, body)
        assert got and [e["id"] for e in got] == [e["id"] for e in ref]
        np.testing.assert_allclose([e["clip_similarity"] for e in got], [e["clip_similarity"] for e in ref],
                                   atol=ATOL)
    direct = clients[1].application.ctx.search_by_image(_png(frames[4]), -1.0, 1)
    assert (direct[0]["videoId"], direct[0]["id"]) == ("video-clipB", "event-20")
    jm, tm = (c.get("/api/models") for c in clients[:2])
    assert payload(tm) == payload(jm) and "siglip" in payload(tm)[0]["name"]


def test_upload_route_embeds_through_the_siglip_engine(params, tmp_path):
    """The upload route's ingest embeds the scene frames with
    ``SiglipEngine.embed_folder``; the stored rows within fp32's bound of
    JAX's, and a search finds the new video."""
    from werkzeug.test import Client

    from evr_tpu.config import DataRootConfig as JRoot
    from evr_tpu.serving import ServingContext as JContext, create_app as jcreate_app
    from evr_tpu_torch.config import DataRootConfig as TRoot
    from evr_tpu_torch.serving import ServingContext as TContext, create_app as tcreate_app

    j, t = _engines(params)
    write_video(tmp_path / "up.mp4", n_frames=60, size=(96, 64), seed=4)
    data = (tmp_path / "up.mp4").read_bytes()
    apps = (Client(jcreate_app(JContext(JRoot(tmp_path / "jax").ensure(), engine=j))),
            Client(tcreate_app(TContext(TRoot(tmp_path / "torch").ensure(), engine=t))))
    for c in apps:
        r = c.post("/api/upload-video", data={"video": (io.BytesIO(data), "up.mp4"), "sync": "1"})
        assert r.status_code == 200, r.get_data(as_text=True)
    rows = [np.load(c.application.ctx.data_root.embedding_dir / "up_embeddings.npy") for c in apps]
    assert rows[0].shape[0] >= 2
    _close(rows[1], rows[0])
    got, ref = _search(apps, {"search_method": "text_clip", "query": "a coloured square", "top_k": 5,
                              "adaptive_threshold": -1.0})
    assert {e["videoId"] for e in got} == {"video-up"}
    assert [(e["id"], e["timestamp"]) for e in got] == [(e["id"], e["timestamp"]) for e in ref]
    np.testing.assert_allclose([e["clip_similarity"] for e in got], [e["clip_similarity"] for e in ref], atol=ATOL)


def test_serving_cli_siglip_matches_jax(params, tmp_path, monkeypatch):
    """``--model-family siglip --siglip-hf DIR`` boots both CLIs on the same
    local HF model with the same default annotators and encodes alike; the
    port forwards ``--params-dtype`` (the JAX CLI drops it) and refuses
    ``--params-dtype auto`` (as JAX does) and ``--checkpoint`` (which JAX
    ignores) with SigLIP at parse time."""
    import torch
    import werkzeug.serving
    from transformers import SiglipConfig as HFConfig, SiglipModel

    from evr_tpu.serving import __main__ as jcli
    from evr_tpu_torch.serving.__main__ import main

    torch.manual_seed(1)
    SiglipModel(HFConfig(
        vision_config={"hidden_size": 32, "intermediate_size": 64, "num_hidden_layers": 1,
                       "num_attention_heads": 2, "image_size": 32, "patch_size": 16},
        text_config={"hidden_size": 32, "intermediate_size": 64, "num_hidden_layers": 1,
                     "num_attention_heads": 2, "max_position_embeddings": 8, "vocab_size": 60},
    )).save_pretrained(tmp_path / "hf")
    apps = []
    monkeypatch.setattr(werkzeug.serving, "run_simple", lambda host, port, app, **kw: apps.append(app))
    common = ["--data-root", str(tmp_path / "root"), "--model-family", "siglip", "--siglip-hf", str(tmp_path / "hf")]
    for flags, want in (([], "LocalOCRAnnotator"), (["--local-ocr", "off", "--zeroshot-objects"],
                                                    "ZeroShotObjectAnnotator")):  # the defaults, then objects
        main(common + flags + ["--device", "cpu"])
        monkeypatch.setattr(sys, "argv", ["evr_tpu.serving"] + common + flags)
        jcli.main()
        (tctx, jctx), apps[:] = (a.ctx for a in apps), []
        assert type(tctx.engine).__name__ == type(jctx.engine).__name__ == "SiglipEngine"
        assert type(tctx.annotator).__name__ == type(jctx.annotator).__name__ == want, flags
    assert tctx.annotator.engine is tctx.engine
    common += ["--local-ocr", "off"]
    staged = np.random.default_rng(5).integers(0, 256, (3, 32, 32, 3), dtype=np.uint8)
    _close(tctx.engine.encode_staged_images(staged), jctx.engine.encode_staged_images(staged))
    _close(tctx.engine.encode_texts(["a cat"]), jctx.engine.encode_texts(["a cat"]))
    main(common + ["--device", "cpu", "--params-dtype", "int8"])
    assert apps.pop().ctx.engine.params_dtype == "int8"
    for bad in (["--params-dtype", "auto"], ["--checkpoint", str(tmp_path / "ft.pt")]):
        with pytest.raises(SystemExit):
            main(common + ["--device", "cpu"] + bad)
    assert not apps
