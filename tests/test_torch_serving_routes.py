"""Every route the port's app serves, against the JAX app on the same data
root (``torch_route_root``): the JSON of each route equal to JAX's, search
scores within 1e-5 (both indexes hold the same rows; only the text encode
differs), HTTP Range requests on frames and videos, the path-traversal
guard, the UMAP route's cache, stats and the models routes; then the CLI's
flags."""

import io

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
pytest.importorskip("werkzeug")

from torch_route_root import build_pair, ids, payload, same_events

SCORE_TOL = 1e-5


@pytest.fixture(scope="module")
def clients(tmp_path_factory):
    jc, tc, _ = build_pair(tmp_path_factory.mktemp("routes"))
    return jc, tc


def _both(clients, method, path, **kwargs):
    """The same request to both apps; a callable ``data`` is called for each
    (a form's file is read once)."""
    jc, tc = clients

    def fresh():
        return {k: v() if callable(v) else v for k, v in kwargs.items()}

    jr, tr = jc.open(path, method=method, **fresh()), tc.open(path, method=method, **fresh())
    assert tr.status_code == jr.status_code, (path, tr.status_code, jr.status_code)
    return jr, tr


def test_ui_and_frontend_dist(clients, tmp_path):
    jr, tr = _both(clients, "GET", "/")
    assert tr.get_data() == jr.get_data() and tr.mimetype == "text/html"
    jr, tr = _both(clients, "GET", "/app/")  # no dist configured: 404 in both
    assert payload(tr) == payload(jr)
    from werkzeug.test import Client

    from evr_tpu_torch.serving import create_app

    dist = tmp_path / "dist"
    (dist / "assets").mkdir(parents=True)
    (dist / "index.html").write_text("<html>spa</html>")
    (dist / "assets" / "app.js").write_text("console.log(1)")
    (tmp_path / "secret.txt").write_text("no")
    spa = Client(create_app(clients[1].application.ctx, frontend_dist=str(dist)))
    assert spa.get("/app/").get_data(as_text=True) == "<html>spa</html>"
    js = spa.get("/app/assets/app.js")
    assert js.status_code == 200 and js.get_data(as_text=True) == "console.log(1)"
    assert spa.get("/app/library/42").get_data(as_text=True) == "<html>spa</html>"  # SPA fallback
    assert spa.get("/app/%2e%2e/secret.txt").status_code == 404


def _rooted(resp, client):
    """The payload with the client's data root written as "<root>"."""
    root = str(client.application.ctx.data_root.root)
    return payload(resp) if root not in resp.get_data(as_text=True) else \
        __import__("json").loads(resp.get_data(as_text=True).replace(root, "<root>"))


def test_videos_and_events_match(clients):
    jr, tr = _both(clients, "GET", "/api/videos")
    assert _rooted(tr, clients[1]) == _rooted(jr, clients[0]) and len(payload(tr)) == 3
    assert payload(tr)[0]["thumbnail"].endswith("frames/clipA/0.jpg")
    for vid in ("video-1", "video-2", "video-9", "nope"):
        jr, tr = _both(clients, "GET", f"/api/video/{vid}/events")
        assert payload(tr) == payload(jr)
    assert len(payload(clients[1].get("/api/video/video-1/events"))) == 20  # 24 frames, at most 20 markers


SEARCHES = [
    {"search_method": "text_clip", "query": "a red car", "top_k": 5},
    {"search_method": "text_clip", "query": "a dog", "top_k": 4, "negative_query": "a car"},
    {"search_method": "text_clip", "query": "a dog", "top_k": 4, "mmr_lambda": 0.4},
    {"query": "đánh nhau trên đường", "top_k": 6, "adaptive_threshold": -1.0},
    {"search_method": "keyword_only", "query": "loi thoat", "text_confidence": 0.2},
    {"search_method": "text_keyword", "query": "exit", "keyword": "exit", "adaptive_threshold": -1.0,
     "text_confidence": 0.1, "top_k": 20},
    {"search_method": "object_only", "query": "car", "object_confidence": 0.3},
    {"search_method": "text_object", "query": "a person", "object": "person", "adaptive_threshold": -1.0,
     "object_confidence": 0.1, "top_k": 20},
    {"search_method": "text_object_keyword", "query": "street", "keyword": "đường", "object": "dog",
     "adaptive_threshold": -1.0, "text_confidence": 0.0, "object_confidence": 0.0, "top_k": 40},
    {"search_method": "speech_only", "query": "chay"},
    {"search_method": "text_speech", "query": "fire", "keyword": "fire", "adaptive_threshold": -1.0, "top_k": 30},
    {"search_method": "video", "query": "a red car", "top_k": 3},
    {"search_method": "text_clip", "query": "a red car", "top_k": 5, "videoId": "video-2"},
    {"search_method": "temporal", "queries": ["a car", "a dog"], "top_k": 3},
    {"search_method": "temporal", "queries": ["a car", "a dog", "a crowd"], "max_gap": 2, "top_k": 2},
    {"search_method": "object_only", "query": "dog", "enableClipSimilarity": True},
]


def test_every_search_method_matches_jax(clients):
    nonempty = 0
    for body in SEARCHES:
        jr, tr = _both(clients, "POST", "/api/search", json={"search_type": "text", **body})
        assert tr.status_code == 200, body
        method = body.get("search_method", "text")
        key = "clip_similarity" if method in ("text_clip", "text_adaptive", "text") else "confidence"
        if method == "temporal":
            key = "total_score"
        same_events(payload(tr)["events"], payload(jr)["events"], key, SCORE_TOL)
        nonempty += bool(payload(tr)["events"])
    assert nonempty >= len(SEARCHES) - 2
    # a repeated request comes from the cache: the same payload
    jr, tr = _both(clients, "POST", "/api/search", json={"search_type": "text", **SEARCHES[0]})
    assert ids(payload(tr)["events"]) == ids(payload(jr)["events"])


def test_files_ranges_and_traversal(clients):
    ctx = clients[1].application.ctx
    for path in ("/api/frame/10.jpg", "/api/frame/frames/clipB/5.jpg",
                 "/api/frame/C:%5Cdata%5Cframes%5C15.jpg", "/api/video/clipA.mp4",
                 "/api/video/videos/clipC.mp4"):
        jr, tr = _both(clients, "GET", path)
        assert tr.status_code == 200 and tr.get_data() == jr.get_data(), path
        assert tr.headers["Accept-Ranges"] == "bytes"
        size = len(tr.get_data())
        jr, tr = _both(clients, "GET", path, headers={"Range": "bytes=4-19"})
        assert tr.status_code == 206 and tr.get_data() == jr.get_data()
        assert tr.headers["Content-Range"] == f"bytes 4-19/{size}"
        jr, tr = _both(clients, "GET", path, headers={"Range": f"bytes={size + 10}-"})
        assert tr.status_code == 416
    outside = ctx.data_root.root.parent / "outside.jpg"
    outside.write_bytes(b"secret")
    for path in (f"/api/frame/{outside}", "/api/frame/../outside.jpg",
                 f"/api/video/{ctx.data_root.root}/../outside.jpg", "/api/frame/none.jpg"):
        jr, tr = _both(clients, "GET", path, follow_redirects=True)  # "//" merges by a 308
        assert tr.status_code == 404 and b"secret" not in tr.get_data(), path


def test_transcribe_voice(clients):
    from evr_tpu.serving.providers import CallableTranscriber as JCall
    from evr_tpu_torch.serving.providers import CallableTranscriber as TCall
    from evr_tpu_torch.serving.providers import LocalWhisperTranscriber

    def audio():
        return {"audio": (io.BytesIO(b"RIFFxxxxWAVE"), "voice.wav"), "language": "vi"}

    jr, tr = _both(clients, "POST", "/api/transcribe-voice", data=audio)
    assert tr.status_code == 501 and payload(tr) == payload(jr)
    jr, tr = _both(clients, "POST", "/api/transcribe-voice", data={})
    assert tr.status_code == 400 and payload(tr) == payload(jr)
    heard = []
    for client, cls in zip(clients, (JCall, TCall)):
        client.application.ctx.transcriber = cls(lambda path, lang: heard.append(lang) or f"heard {lang}")
    try:
        jr, tr = _both(clients, "POST", "/api/transcribe-voice", data=audio)
        assert tr.status_code == 200 and payload(tr)["text"] == payload(jr)["text"] == "heard vi"
        assert set(payload(tr)) == set(payload(jr)) == {"text", "audio_file"}
    finally:
        for client in clients:
            client.application.ctx.transcriber = None
    # the on-card provider wraps a WhisperASR (tests/test_torch_whisper_serving.py holds it to JAX's)
    class Ids:
        cfg = type("Cfg", (), {"sampling_rate": 16000})

        def transcribe(self, audio, prompt_ids=None):
            return [[len(audio), *(prompt_ids or [])]]

    wav = io.BytesIO()
    import wave

    with wave.open(wav, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(np.zeros(160, np.int16).tobytes())
    clients[1].application.ctx.transcriber = LocalWhisperTranscriber(Ids(), {"vi": [7]})
    try:
        tr = clients[1].post("/api/transcribe-voice",
                             data={"audio": (io.BytesIO(wav.getvalue()), "voice.wav"), "language": "vi"})
        assert tr.status_code == 200 and payload(tr)["text"] == "160 7"
    finally:
        clients[1].application.ctx.transcriber = None


def test_umap_route_and_its_cache(clients):
    body = {"video_names": None, "n_neighbors": 8, "min_dist": 0.1, "metric": "cosine", "method": "pca"}
    jr, tr = _both(clients, "POST", "/api/visualization/umap", json=body)
    j, t = payload(jr), payload(tr)
    assert set(t) == set(j)
    for key in j:
        if key == "coordinates":
            np.testing.assert_allclose(np.array(t[key]), np.array(j[key]), atol=SCORE_TOL)
        else:
            assert t[key] == j[key], key
    ctx = clients[1].application.ctx
    body = {"video_names": ["clipA", "clipC"], "n_neighbors": 8}
    first = clients[1].post("/api/visualization/umap", json=body)
    assert first.status_code == 200 and payload(first)["dimensionality_reduction"]["method"] == "umap"
    assert len(payload(first)["coordinates"]) == 37
    cached = len(ctx.viz_cache)
    import evr_tpu_torch.viz as viz

    real, calls = viz.generate_visualization, []
    viz.generate_visualization = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        again = clients[1].post("/api/visualization/umap", json=body)
    finally:
        viz.generate_visualization = real
    assert calls == [] and len(ctx.viz_cache) == cached and again.get_data() == first.get_data()
    for bad in ({"video_names": "clipA"}, {"n_neighbors": "x"}, {"metric": 3}, [1, 2],
                {"video_names": ["nope"]}):
        jr, tr = _both(clients, "POST", "/api/visualization/umap", json=bad)
        assert payload(tr) == payload(jr), bad


def test_available_models_and_active_model(clients):
    for method, path, kwargs in (
        ("GET", "/api/videos/available", {}),
        ("GET", "/api/models", {}),
        ("GET", "/api/models/active", {}),
        ("POST", "/api/models/active", {"json": {"model": "original"}}),
        ("POST", "/api/models/active", {"json": {"model": "nope"}}),
        ("POST", "/api/models/active", {"json": {}}),
        ("POST", "/api/models/active", {"json": [1]}),
    ):
        jr, tr = _both(clients, method, path, **kwargs)
        assert payload(tr) == payload(jr), (method, path, kwargs)
    assert payload(clients[1].get("/api/videos/available"))["count"] == 3


def test_stats_and_protocol_answers(clients):
    _both(clients, "POST", "/api/search", json={"query": "a boat", "adaptive_threshold": -1.0})
    jr, tr = _both(clients, "GET", "/api/stats")
    j, t = payload(jr), payload(tr)
    assert set(t) == set(j) and t["index"] == j["index"] and t["active_model"] == j["active_model"]
    assert set(t["caches"]) == {"search", "viz"} and t["caches"]["search"] > 0
    assert "search/text" in t["timings"] and set(t["timings"]["search/text"]) == \
        set(j["timings"]["search/text"])
    for method, path in (("OPTIONS", "/api/search"), ("GET", "/api/nope"), ("GET", "/api/search"),
                         ("PUT", "/api/models/active"), ("GET", "/health")):
        jr, tr = _both(clients, method, path)
        assert payload(tr) == payload(jr), (method, path)
    assert tr.headers["Access-Control-Allow-Origin"] == "*"


def _annotator_kinds(ann):
    """The annotator a CLI built, by class names (a composite's in order)."""
    if ann is None:
        return None
    children = getattr(ann, "annotators", None)
    return [type(a).__name__ for a in children] if children else type(ann).__name__


def test_cli_refuses_unported_flags(capsys, tmp_path, monkeypatch):
    """The flag combinations no engine serves are refused at parse time
    (``--params-dtype auto`` and ``--checkpoint`` with SigLIP; the SigLIP
    flags themselves serve since A17's SigLIP part,
    tests/test_torch_siglip_engine.py); the annotator flags build the
    annotators the JAX CLI builds."""
    import sys

    import werkzeug.serving

    from evr_tpu.serving import __main__ as jcli
    from evr_tpu_torch.serving.__main__ import main

    # --shard-index boots since the mesh was ported (tests/test_torch_mesh.py)
    for argv, said in ((["--model-family", "siglip", "--params-dtype", "auto"], "CLIP-only"),
                       (["--model-family", "siglip", "--checkpoint", "ft.pt"], "CLIP-only"),
                       (["--frontend-dist", "dist", "--transcriber", "none", "--zeroshot-objects",
                         "--model-family", "siglip", "--siglip-hf", "/x", "--params-dtype", "auto"],
                        "CLIP-only")):
        with pytest.raises(SystemExit):
            main(argv)
        assert said in capsys.readouterr().err, argv
    apps = []
    monkeypatch.setattr(werkzeug.serving, "run_simple", lambda host, port, app, **kw: apps.append(app))
    common = ["--data-root", str(tmp_path / "root"), "--model", "ViT-Tiny-Test"]
    for flags, want in (([], "LocalOCRAnnotator"), (["--local-ocr", "off"], None),
                        (["--local-ocr", "on"], "LocalOCRAnnotator"),
                        (["--zeroshot-objects", "--local-ocr", "off"], "ZeroShotObjectAnnotator"),
                        (["--zeroshot-objects"], ["ZeroShotObjectAnnotator", "LocalOCRAnnotator"])):
        main(common + flags + ["--device", "cpu"])
        monkeypatch.setattr(sys, "argv", ["evr_tpu.serving"] + common + flags)
        jcli.main()
        (tctx, jctx), apps[:] = (a.ctx for a in apps), []
        assert _annotator_kinds(tctx.annotator) == _annotator_kinds(jctx.annotator) == want, flags
        for a in getattr(tctx.annotator, "annotators", [tctx.annotator]):
            if type(a).__name__ == "LocalOCRAnnotator":
                assert a.device.type == "cpu"
            elif a is not None:
                assert a.engine is tctx.engine
