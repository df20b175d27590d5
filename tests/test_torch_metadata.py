"""The port's ``MetadataStore`` against the JAX package's: the same seeded
videos (OCR text with Vietnamese accents, objects, tags, captions) and
transcripts go into both, and every lookup and match function must give the
same answer for the same query, accented or folded: labels and frames
exactly, confidences exactly (they are the stored floats or constants)."""

import json

import numpy as np
import pytest

from evr_tpu.query import metadata as jmeta
from evr_tpu_torch.query import metadata as tmeta

OCR = ["LỐI THOÁT", "lối thoát hiểm", "Đường phố", "EXIT sign", "cấm vào", "Bệnh viện", "xe máy"]
OBJECTS = ["person", "knife", "car", "motorbike", "dog", "Xe đạp"]
TAGS = ["weapon", "đám đông", "night", "Đường"]
CAPTIONS = ["a crowd fighting with sticks", "người đàn ông đang chạy", "a red car at night"]
SPEECH = ["xin chào các bạn", "hãy chạy ra lối thoát", "the car is on fire", "Đi đường này",
          "nothing to see here"]
QUERIES = ["loi thoat", "lối thoát", "LỐI", "duong", "đường", "exit", "person", "xe", "Xe dap",
           "crowd", "đám đông", "dam dong", "chay", "fire", "car", "nope", ""]


def _records(name, n, rng):
    recs = []
    for i in range(n):
        def dets(pool, p):
            return [{"label": str(rng.choice(pool)), "confidence": float(np.round(rng.uniform(0.1, 1), 3)),
                     "bounding_box": [0, 0, 1, 1]} for _ in range(rng.integers(0, 3)) if rng.random() < p]
        recs.append({
            "id": f"{name}-{i}", "frameidx": i * 5, "frameid": f"{i * 5}.jpg",
            "video": f"videos/{name}.mp4", "filepath": f"frames/{name}/{i * 5}.jpg",
            "tags": [str(t) for t in rng.choice(TAGS, rng.integers(0, 3), replace=False)],
            "metadata": {"caption": str(rng.choice(CAPTIONS))} if rng.random() < 0.3 else {},
            "text_detections": {"detections": dets(OCR, 0.7)},
            "object_detections": {"detections": dets(OBJECTS, 0.7)},
        })
    return recs


def _segments(rng):
    t, out = 0.0, []
    for _ in range(6):
        dur = float(np.round(rng.uniform(0.5, 3.0), 2))
        out.append({"start": t, "end": t + dur, "text": str(rng.choice(SPEECH))})
        t += dur + float(np.round(rng.uniform(0, 1), 2))
    out.append({"start": 99.0, "end": 100.0, "text": "   "})  # blank: dropped
    return out[::-1]  # unsorted on purpose


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    rng = np.random.default_rng(15)
    tmp = tmp_path_factory.mktemp("meta")
    pair = (jmeta.MetadataStore(), tmeta.MetadataStore())
    for v, (name, n, fps) in enumerate((("vA", 24, 10.0), ("vB", 17, 25.0), ("vC", 9, 4.0))):
        recs, segs = _records(name, n, rng), _segments(rng)
        (tmp / f"{name}.json").write_text(json.dumps(recs, ensure_ascii=False), encoding="utf-8")
        payload = {"segments": segs} if v % 2 else segs
        (tmp / f"{name}_tr.json").write_text(json.dumps(payload, ensure_ascii=False), encoding="utf-8")
        for store in pair:
            store.load_video_json(name, tmp / f"{name}.json", fps=fps)
            if name != "vC":
                store.load_transcript_json(name, tmp / f"{name}_tr.json")
    return pair


def _frame_view(fr):
    return (fr.raw, fr.frameidx, fr.frameid, fr.text_labels, fr.object_labels, fr.tags, fr.caption)


def test_constants_match():
    for k in ("CAPTION_CONF", "TAG_CONF", "OCR_OBJECT_SCALE", "SPEECH_CONF"):
        assert getattr(tmeta, k) == getattr(jmeta, k)


def test_prefolded_frames_match(stores):
    j, t = stores
    assert t.videos() == j.videos() == ["vA", "vB", "vC"]
    for v in j.videos():
        assert [_frame_view(f) for f in t.frames(v)] == [_frame_view(f) for f in j.frames(v)]
        assert t.fps(v) == j.fps(v)
        assert t.has_transcript(v) == j.has_transcript(v)
        assert t._transcripts.get(v) == j._transcripts.get(v)
        for f in j.frames(v):
            assert _frame_view(t.frame_by_id(v, f.frameid)) == _frame_view(f)
            assert _frame_view(t.frame_by_idx(v, f.frameidx)) == _frame_view(f)
    assert t.frame_by_id("vA", "nope.jpg") is j.frame_by_id("vA", "nope.jpg") is None
    assert any(label != folded for f in t.frames("vA") for label, folded, _ in f.text_labels)


def test_keyword_matches(stores):
    j, t = stores
    for v in j.videos():
        for q in QUERIES:
            assert [t.keyword_best_match(f, q) for f in t.frames(v)] == \
                [j.keyword_best_match(f, q) for f in j.frames(v)], (v, q)
            for limit in (None, 2):
                assert t.keyword_frames(v, q, limit) == j.keyword_frames(v, q, limit)
    assert t.keyword_frames("vA", "loi thoat") == t.keyword_frames("vA", "lối thoát") != []


@pytest.mark.parametrize("include_ocr", [True, False])
def test_object_matches(stores, include_ocr):
    j, t = stores
    hits = 0
    for v in j.videos():
        for q in QUERIES:
            got = [t.object_best_match(f, q, include_ocr=include_ocr) for f in t.frames(v)]
            assert got == [j.object_best_match(f, q, include_ocr=include_ocr) for f in j.frames(v)]
            hits += sum(g[0] for g in got)
    assert hits > 0


def test_speech_matches(stores):
    j, t = stores
    found = 0
    for v in j.videos():
        for q in QUERIES:
            assert t.speech_matches(v, q) == j.speech_matches(v, q)
            assert [t.speech_best_match(v, f, q) for f in t.frames(v)] == \
                [j.speech_best_match(v, f, q) for f in j.frames(v)]
            for limit in (None, 1):
                got = [(_frame_view(f), s) for f, s in t.speech_frames(v, q, limit)]
                assert got == [(_frame_view(f), s) for f, s in j.speech_frames(v, q, limit)]
                found += len(got)
    assert found > 0


def test_set_fps_and_remove_video(stores):
    j, t = stores
    for store in (j, t):
        store.set_fps("vB", 5.0)
    assert [t.speech_best_match("vB", f, "car") for f in t.frames("vB")] == \
        [j.speech_best_match("vB", f, "car") for f in j.frames("vB")]
    for store in (j, t):
        store.remove_video("vC")
    assert t.videos() == j.videos() == ["vA", "vB"]
    assert t.frames("vC") == [] and t.frame_by_idx("vC", 0) is None and not t.has_transcript("vC")
