"""The upload routes of the port's app against the JAX app's, on twin data
roots with the same ViT-Tiny-Test params.

``POST /api/upload-video`` (``sync=1`` and asynchronous) and ``GET
/api/upload-status/<job_id>``: status codes and payloads equal except the
ids, the dates and the root in the paths; 400 without a file, 404 for an
unknown job, a failed ingest reported in the job (and as 500 with
``sync=1``); a search after the upload finds the new video's frames, and the
port's ingested rows are within the fp32 encode bound of JAX's.
"""

import io
import json
import time

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
pytest.importorskip("werkzeug")

from werkzeug.test import Client

from evr_tpu.config import DataRootConfig as JRoot
from evr_tpu.serving import ServingContext as JContext, create_app as jcreate_app
from evr_tpu_torch.config import DataRootConfig as TRoot
from evr_tpu_torch.serving import ServingContext as TContext, create_app as tcreate_app
from torch_ingest_root import ATOL, tiny_params, twin_engines, write_video

WAIT_S = 120


@pytest.fixture(scope="module")
def apps(tmp_path_factory):
    base = tmp_path_factory.mktemp("upload")
    j, t = twin_engines(tiny_params(5))
    jctx = JContext(JRoot(base / "jax").ensure(), engine=j)
    tctx = TContext(TRoot(base / "torch").ensure(), engine=t)
    videos = {}
    for name, seed in (("first", 1), ("second", 2), ("third", 3)):
        write_video(base / f"{name}.mp4", n_frames=70, size=(96, 64), seed=seed)
        videos[name] = (base / f"{name}.mp4").read_bytes()
    return Client(jcreate_app(jctx)), Client(tcreate_app(tctx)), videos


def _payload(resp):
    return json.loads(resp.get_data(as_text=True))


def _norm(obj, client):
    """Drop what differs by nature (ids, dates), and the data root from paths."""
    root = str(client.application.ctx.data_root.root)
    text = json.dumps(obj).replace(root, "ROOT")
    out = json.loads(text)
    for key in ("job_id", "status_url"):
        out.pop(key, None)
    if isinstance(out.get("video"), dict):
        out["video"].pop("id", None)
        out["video"].pop("uploadDate", None)
    return out


def _upload(client, name, data, **form):
    return client.post("/api/upload-video", data={"video": (io.BytesIO(data), f"{name}.mp4"), **form})


def test_sync_upload_matches_jax(apps):
    jc, tc, videos = apps
    jr, tr = (_upload(c, "first", videos["first"], sync="1", model="original") for c in (jc, tc))
    assert tr.status_code == jr.status_code == 200
    got, ref = _payload(tr), _payload(jr)
    assert got["status"] == "success" and got["video"]["frames"] == 2
    assert got["video"]["uploadDate"] == time.strftime("%Y-%m-%d")
    assert _norm(got, tc) == _norm(ref, jc)


def test_async_upload_and_status_match_jax(apps):
    jc, tc, videos = apps
    replies = []
    for c in (jc, tc):
        resp = _upload(c, "second", videos["second"])
        assert resp.status_code == 202
        body = _payload(resp)
        assert body["status_url"] == f"/api/upload-status/{body['job_id']}"
        job = c.application.ctx.ingest_jobs.wait(body["job_id"], timeout=WAIT_S)
        assert job.state == "done", job.error
        status = c.get(body["status_url"])
        assert status.status_code == 200
        replies.append((body, _payload(status)))
    (jb, js), (tb, ts) = replies
    assert _norm(tb, tc) == _norm(jb, jc) == {"status": "processing", "video_name": "second"}
    assert ts["state"] == "done" and ts["stage"] == "done" and ts["video"]["frames"] == ts["frames_total"]
    assert _norm(ts, tc) == _norm(js, jc)


def test_search_after_upload_finds_the_video(apps):
    jc, tc, _ = apps
    body = {"query": "a coloured square", "top_k": 10, "search_method": "text_clip",
            "adaptive_threshold": -1.0}
    got, ref = (_payload(c.post("/api/search", json=body))["events"] for c in (tc, jc))
    assert {e["videoId"] for e in got} == {"video-first", "video-second"}
    assert [(e["videoId"], e["timestamp"]) for e in got] == [(e["videoId"], e["timestamp"]) for e in ref]
    np.testing.assert_allclose([e["clip_similarity"] for e in got],
                               [e["clip_similarity"] for e in ref], atol=ATOL)
    for name in ("first", "second"):
        rows = [np.load(c.application.ctx.data_root.embedding_dir / f"{name}_embeddings.npy")
                for c in (tc, jc)]
        np.testing.assert_allclose(rows[0], rows[1], rtol=0, atol=ATOL)


def test_missing_file_and_unknown_job(apps):
    jc, tc, _ = apps
    for c in (jc, tc):
        assert c.post("/api/upload-video", data={"sync": "1"}).status_code == 400
    tr, jr = (c.get("/api/upload-status/0123456789abcdef") for c in (tc, jc))
    assert tr.status_code == jr.status_code == 404 and _payload(tr) == _payload(jr)


def test_failed_ingest_is_reported_as_in_jax(apps):
    jc, tc, _ = apps
    replies = []
    for c in (jc, tc):
        sync = _upload(c, "broken", b"not a video", sync="1")
        resp = _upload(c, "broken", b"not a video")
        job_id = _payload(resp)["job_id"]
        c.application.ctx.ingest_jobs.wait(job_id, timeout=WAIT_S)
        replies.append((sync.status_code, _norm(_payload(sync), c), _norm(_payload(c.get(f"/api/upload-status/{job_id}")), c)))
    assert replies[0] == replies[1]
    code, sync_body, status = replies[1]
    assert code == 500 and sync_body["error"].startswith("Ingest failed: OSError: cannot open video")
    assert status["state"] == status["stage"] == "error"
    assert [e["title"] for e in _payload(tc.get("/api/videos"))] == ["first", "second"]
