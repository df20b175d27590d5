"""The port's app against the frontend contract and the built-in UI's.

``tests/golden/frontend_contract.json`` records every field the reference
React frontend sends or reads; each endpoint the port serves is replayed
through the WSGI client and must carry them (the JAX package's
``tests/test_frontend_contract.py``, over a root written by
``torch_route_root``; the upload routes ingest a cv2-written video into it).
The UI checks are ``tests/test_ui_contract.py``'s, on the port's page and the
port's routes.
"""

import io
import json
import pathlib
import re

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
pytest.importorskip("werkzeug")

from torch_route_root import build_pair, payload

CONTRACT = json.loads(
    (pathlib.Path(__file__).parent / "golden" / "frontend_contract.json").read_text()
)["endpoints"]


@pytest.fixture(scope="module")
def client(tmp_path_factory):
    return build_pair(tmp_path_factory.mktemp("contract"))[1]


def _fields(obj, fields, where):
    missing = [f for f in fields if f not in obj]
    assert not missing, f"{where}: frontend-read fields missing: {missing}"


def test_listing_events_models_and_available(client):
    videos = payload(client.get("/api/videos"))
    assert videos
    for v in videos:
        _fields(v, CONTRACT["GET /api/videos"]["item_fields"], "videos item")
    events = payload(client.get("/api/video/video-1/events"))
    assert events
    for e in events:
        _fields(e, CONTRACT["GET /api/video/<id>/events"]["item_fields"], "events item")
    for m in payload(client.get("/api/models")):
        _fields(m, CONTRACT["GET /api/models"]["item_fields"], "models item")
    _fields(payload(client.get("/api/models/active")), CONTRACT["GET /api/models/active"]["fields"],
            "models/active")
    assert client.post("/api/models/active", json={"model": "original"}).status_code == 200
    spec = CONTRACT["GET /api/videos/available"]
    data = payload(client.get("/api/videos/available"))
    _fields(data, spec["fields"], "videos/available")
    assert data["available_videos"]
    for v in data["available_videos"]:
        _fields(v, spec["item_fields"], "available item")


def test_search_accepts_every_frontend_param(client):
    spec = CONTRACT["POST /api/search"]
    body = {
        "search_type": "text", "query": "red frame", "min_confidence": 0.0, "top_k": 5,
        "model": "original", "videoId": "video-1", "adaptive_threshold": 0.0,
        "text_confidence": 0.0, "object_confidence": 0.0, "return_all_confidences": True,
        "search_method": "text_clip", "keyword": "", "object": "",
    }
    assert set(body) | {"image_url"} == set(spec["request_params_sent"]["params"])
    for method in ("text_clip", "text_object_keyword", "keyword_only", "video"):
        resp = client.post("/api/search", json={**body, "search_method": method, "keyword": "exit",
                                                "object": "car", "adaptive_threshold": -1.0})
        assert resp.status_code == 200
        data = payload(resp)
        _fields(data, spec["fields"], "search response")
        for e in data["events"]:
            _fields(e, spec["event_fields"], f"{method} event")
    assert payload(client.post("/api/search", json=body))["events"]


def test_transcribe_umap_and_binaries(client):
    from evr_tpu_torch.serving.providers import CallableTranscriber

    spec = CONTRACT["POST /api/transcribe-voice"]
    ctx = client.application.ctx
    ctx.transcriber = CallableTranscriber(lambda path, lang: "heard")
    try:
        resp = client.post("/api/transcribe-voice", data={"audio": (io.BytesIO(b"RIFFxxxx"), "voice.wav")})
        assert resp.status_code == 200
        _fields(payload(resp), spec["fields"], "transcribe")
    finally:
        ctx.transcriber = None
    resp = client.post("/api/transcribe-voice", data={})
    assert resp.status_code >= 400
    _fields(payload(resp), spec["error_fields"], "transcribe error")
    spec = CONTRACT["POST /api/visualization/umap"]
    resp = client.post("/api/visualization/umap",
                       json={"video_names": None, "n_neighbors": 15, "min_dist": 0.1, "metric": "cosine"})
    assert resp.status_code == 200
    viz = payload(resp)
    _fields(viz, spec["fields"], "umap")
    assert len(viz["coordinates"]) == len(viz["video_labels"]) == len(viz["metadata"]) > 0
    for point in viz["metadata"]:
        _fields(point, spec["metadata_fields"], "umap point")
    assert all(len(c) == 2 for c in viz["coordinates"])
    for path in ("/api/frame/15.jpg", "/api/video/clipA.mp4"):
        full = client.get(path)
        part = client.get(path, headers={"Range": "bytes=0-9"})
        assert full.status_code == 200 and full.headers["Accept-Ranges"] == "bytes"
        assert part.status_code == 206 and part.get_data() == full.get_data()[:10]


def _write_video(path, n=40):
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 25.0, (64, 64))
    for i in range(n):
        frame = np.zeros((64, 64, 3), np.uint8)
        frame[:, :, 0 if i < n // 2 else 2] = 200
        writer.write(frame)
    writer.release()
    return path.read_bytes()


def test_upload_routes_answer_501_naming_ingest(client, tmp_path):
    """The upload routes, which answered 501 before ingest was ported, now
    carry the contract's fields: the synchronous upload's payload, the async
    202 and the upload status, whose final state carries the same payload."""
    legacy = CONTRACT["POST /api/upload-video"]
    resp = client.post("/api/upload-video", data={
        "video": (io.BytesIO(_write_video(tmp_path / "up.mp4")), "up.mp4"), "sync": "1"})
    assert resp.status_code == 200
    data = payload(resp)
    _fields(data, legacy["fields"], "upload response")
    assert data["status"] == "success" and data["video"]["frames"] == 2
    _fields(data["video"], legacy["video_fields"], "upload response .video")

    resp = client.post("/api/upload-video", data={
        "video": (io.BytesIO(_write_video(tmp_path / "up_async.mp4")), "up_async.mp4")})
    assert resp.status_code == 202
    data = payload(resp)
    _fields(data, CONTRACT["POST /api/upload-video (async)"]["fields"], "async upload response")
    job = client.application.ctx.ingest_jobs.wait(data["job_id"], timeout=120)
    assert job.state == "done", job.error
    status = payload(client.get(data["status_url"]))
    _fields(status, CONTRACT["GET /api/upload-status/<id>"]["fields"], "upload status")
    _fields(status, legacy["fields"], "final upload status")
    _fields(status["video"], legacy["video_fields"], "final status .video")
    assert client.get("/api/upload-status/abc123").status_code == 404


def _document():
    from evr_tpu_torch.serving.ui import INDEX_HTML

    head, script = INDEX_HTML.split("<script>", 1)
    return head, script.split("</script>", 1)[0]


def test_ui_contract(client):
    from evr_tpu.serving.ui import INDEX_HTML as JAX_HTML
    from evr_tpu_torch.serving.ui import INDEX_HTML

    assert INDEX_HTML == JAX_HTML
    html, script = _document()
    referenced = set(re.findall(r"\$\('([^']+)'\)", script)) | set(re.findall(r"getElementById\('([^']+)'\)", script))
    assert not referenced - set(re.findall(r'id="([^"]+)"', html))
    urls = set(re.findall(r"['\"](/api/[a-z\-]+[a-z])", script)) | {"/api/video/", "/api/frame/"}
    routes = [r.rule for r in client.application.url_map.iter_rules()]
    for url in sorted(urls):
        assert any(rule == url or rule.startswith(url) or url.startswith(rule.split("<")[0])
                   for rule in routes), url
    assert set(re.findall(r'data-view="([^"]+)"', html)) == \
        set(re.findall(r'<section id="view-([^"]+)"', html)) == {"library", "search", "player", "viz"}
    select = html.split('id="method"', 1)[1].split("</select>", 1)[0]
    from evr_tpu_torch.query import SEARCH_METHODS

    assert set(re.findall(r'value="([^"]+)"', select)) >= set(SEARCH_METHODS) | {"temporal"}
    stripped = re.sub(r"'(?:\\.|[^'\\])*'|\"(?:\\.|[^\"\\])*\"|`(?:\\.|[^`\\])*`", "", script)
    stripped = re.sub(r"//[^\n]*", "", stripped)
    for a, b in ("{}", "()", "[]"):
        assert stripped.count(a) == stripped.count(b)
    # every route of the JAX app is routed by the port's
    from evr_tpu.serving.app import create_app as jcreate_app

    jroutes = {r.rule for r in jcreate_app(client.application.ctx).url_map.iter_rules()}
    assert jroutes == set(routes) and len(routes) == 17
