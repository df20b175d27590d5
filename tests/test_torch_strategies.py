"""Every retrieval strategy of the port against the JAX package's.

Both ``QueryEngine``s search one seeded index (the same frame embeddings in
each package's ``FrameIndex``) and one seeded metadata store (OCR text with
Vietnamese accents, objects, tags, captions, one transcript per video), with
ViT-Tiny-Test params carried across and the Vietnamese preprocessor on both.
Each method of ``SEARCH_METHODS``, and ``query_temporal``, must return the
JAX package's events: frames exactly, fp32 scores within 1e-5, the other
fields equal; two events may trade places only where their scores lie within
that tolerance of each other. A stub engine (fixed query directions) then
replays the JAX tests' edge cases on both packages, which must agree exactly.
"""

import json

import numpy as np
import pytest

import jax

from evr_tpu.index import EmbeddingEngine as JEngine
from evr_tpu.index import FrameIndex as JIndex
from evr_tpu.models.clip import init_clip_params
from evr_tpu.models.variants import get_model_config
from evr_tpu.query import MetadataStore as JStore
from evr_tpu.query import QueryEngine as JQE
from evr_tpu.query import SEARCH_METHODS as J_METHODS
from evr_tpu.query import VietnamesePreprocessor as JPre
from evr_tpu.query import temporal as jtemporal
from evr_tpu.query.translate import DictionaryTranslator as JTr
from evr_tpu_torch.index import EmbeddingEngine as TEngine
from evr_tpu_torch.index import FrameIndex as TIndex
from evr_tpu_torch.query import MetadataStore as TStore
from evr_tpu_torch.query import QueryEngine as TQE
from evr_tpu_torch.query import SEARCH_METHODS as T_METHODS
from evr_tpu_torch.query import VietnamesePreprocessor as TPre
from evr_tpu_torch.query import temporal as ttemporal
from evr_tpu_torch.query.translate import DictionaryTranslator as TTr

SCORE_TOL = 1e-5
SCORED = ("clip_similarity", "confidence", "video_score", "total_score")
VIDEOS = {"vA": 30, "vB": 22, "vC": 26}
OCR = ["LỐI THOÁT", "lối thoát hiểm", "Đường phố", "EXIT sign", "cấm vào"]
OBJECTS = ["person", "knife", "car", "motorbike", "dog"]
TAGS = ["weapon", "đám đông", "night"]
CAPTIONS = ["a crowd fighting with sticks", "người đàn ông đang chạy", "a red car at night"]
SPEECH = ["hãy chạy ra lối thoát", "the car is on fire", "Đi đường này", "xin chào"]


def _records(name, n, rng):
    def dets(pool):
        return [{"label": str(rng.choice(pool)), "confidence": float(np.round(rng.uniform(0.2, 1), 3)),
                 "bounding_box": [0, 0, 1, 1]} for _ in range(rng.integers(0, 3))]

    return [{
        "id": f"{name}-{i}", "frameidx": i, "frameid": f"{i}.jpg", "video": f"videos/{name}.mp4",
        "filepath": f"frames/{name}/{i}.jpg",
        "tags": [str(t) for t in rng.choice(TAGS, rng.integers(0, 2), replace=False)],
        "metadata": {"caption": str(rng.choice(CAPTIONS))} if rng.random() < 0.4 else {},
        "text_detections": {"detections": dets(OCR)},
        "object_detections": {"detections": dets(OBJECTS)},
    } for i in range(n)]


@pytest.fixture(scope="module")
def engines():
    cfg = get_model_config("ViT-Tiny-Test")
    params = jax.tree.map(np.asarray, init_clip_params(jax.random.PRNGKey(3), cfg))
    rng = np.random.default_rng(15)
    jidx = JIndex(embed_dim=cfg.embed_dim, pad_multiple=8)
    tidx = TIndex(embed_dim=cfg.embed_dim, pad_multiple=8, device="cpu")
    jstore, tstore = JStore(), TStore()
    for name, n in VIDEOS.items():
        emb = rng.standard_normal((n, cfg.embed_dim)).astype(np.float32)
        recs = _records(name, n, rng)
        t, segs = 0.0, []
        for text in rng.choice(SPEECH, 5):
            segs.append({"start": t, "end": t + 2.0, "text": str(text)})
            t += 2.5
        for idx, store in ((jidx, jstore), (tidx, tstore)):
            idx.add_video(name, emb, [r["frameid"] for r in recs])
            store.add_video(name, json.loads(json.dumps(recs)), fps=2.0)
            store.add_transcript(name, segs)
    jeng = JEngine("ViT-Tiny-Test", params=params, cfg=cfg, batch_size=4)
    teng = TEngine("ViT-Tiny-Test", params=params, batch_size=4, device="cpu")
    jqe = JQE(jeng, jidx, jstore, preprocessor=JPre(translator=JTr()))
    tqe = TQE(teng, tidx, tstore, preprocessor=TPre(translator=TTr()))
    assert jqe._searcher is not None and tqe._searcher is not None
    return jqe, tqe


def _ids(events):
    return [(e.get("videoId"), e.get("id")) for e in events]


def same_events(got, ref, key):
    """Equal lists of events up to near-tie swaps: where two positions hold
    different frames, their ``key`` scores must lie within SCORE_TOL."""
    assert len(got) == len(ref), (_ids(got), _ids(ref))
    for g, r in zip(got, ref):
        if _ids([g]) != _ids([r]):
            assert abs(g[key] - r[key]) <= SCORE_TOL, (key, _ids([g]), _ids([r]), g[key], r[key])
    by_id = {i: e for i, e in zip(_ids(ref), ref)}
    for i, g in zip(_ids(got), got):
        r = by_id[i]
        assert set(g) == set(r), i
        for k, v in r.items():
            if k in SCORED:
                assert abs(g[k] - v) <= SCORE_TOL, (i, k, g[k], v)
            elif k == "chain":
                same_events(g[k], v, "clip_similarity")
            else:
                assert g[k] == v, (i, k, g[k], v)


CALLS = {
    "text_clip": [dict(query="a red car", top_k=5), dict(query="đánh nhau trên đường", top_k=4,
                  video_name="vB"), dict(query="a dog", top_k=5, mmr_lambda=0.5),
                  dict(query="people", top_k=6, negative_query="a car", negative_weight=0.6)],
    "text_adaptive": [dict(query="a crowd at night", adaptive_threshold=-1.0, top_k=6),
                      dict(query="a crowd at night", adaptive_threshold=0.05, top_k=8, mmr_lambda=0.3)],
    "keyword_only": [dict(keyword="loi thoat", adaptive_threshold=0.3, top_k=10),
                     dict(keyword="Đường", adaptive_threshold=0.0, top_k=5, video_name="vC")],
    "text_keyword": [dict(query="an exit", adaptive_threshold=-1.0, top_k=10, keyword="lối thoát",
                          text_confidence=0.2), dict(query="exit sign", adaptive_threshold=-1.0, top_k=10)],
    "object_only": [dict(query="car", adaptive_threshold=0.9, top_k=10),
                    dict(query="dam dong", adaptive_threshold=0.1, top_k=6, video_name="vA")],
    "text_object": [dict(query="a person", adaptive_threshold=-1.0, top_k=10, object_keyword="person",
                         object_confidence=0.3), dict(query="night", adaptive_threshold=-1.0, top_k=10)],
    "text_object_keyword": [dict(query="danger", adaptive_threshold=-1.0, top_k=15, keyword="exit",
                                 object_keyword="person", text_confidence=0.2, object_confidence=0.2)],
    "speech_only": [dict(keyword="loi thoat", top_k=10), dict(keyword="fire", top_k=3, video_name="vB")],
    "text_speech": [dict(query="running", adaptive_threshold=-1.0, top_k=10, keyword="chạy"),
                    dict(query="the car is on fire", adaptive_threshold=-1.0, top_k=10)],
    "video": [dict(query="a red car", top_k=3), dict(query="a dog", top_k=2, frames_per_video=2),
              dict(query="a dog", top_k=2, video_name="vA")],
}
SORT_KEY = {"text_clip": "clip_similarity", "text_adaptive": "clip_similarity"}


@pytest.mark.parametrize("method", T_METHODS)
def test_strategy_matches_jax(engines, method):
    jqe, tqe = engines
    assert T_METHODS == J_METHODS
    nonempty = 0
    for kwargs in CALLS[method]:
        ref, got = jqe.search(method, **kwargs), tqe.search(method, **kwargs)
        same_events(got, ref, SORT_KEY.get(method, "confidence"))
        nonempty += bool(got)
    assert nonempty, f"{method}: every call returned nothing"


def test_temporal_matches_jax(engines):
    jqe, tqe = engines
    for kwargs in (dict(queries=["a car", "a crowd"], top_k=3),
                   dict(queries=["người đàn ông", "a dog", "fire"], top_k=2, max_gap=3),
                   dict(queries=["a car", "a dog"], top_k=2, video_name="vB")):
        ref, got = jqe.query_temporal(**kwargs), tqe.query_temporal(**kwargs)
        assert got
        same_events(got, ref, "total_score")
    with pytest.raises(ValueError):
        tqe.query_temporal(["only one"])


class FakeEngine:
    """Known queries map to fixed directions; the rest to direction 0."""

    def __init__(self, dim=8):
        self.dim, self.vecs = dim, {"fight": 1, "danger sign": 2, "crowd": 3}

    def get_text_features(self, query):
        v = np.zeros(self.dim, np.float32)
        v[self.vecs.get(query, 0) % self.dim] = 1.0
        return v

    def encode_texts(self, queries):
        return np.stack([self.get_text_features(q) for q in queries])


def _stub(pkg):
    index_cls, store_cls, qe_cls = pkg
    emb = np.zeros((6, 8), np.float32)
    for i, d in enumerate((1, 2, 3, 1, 2, 0)):
        emb[i, d] = 1.0 - 0.1 * (i // 3)
    idx = index_cls(embed_dim=8, pad_multiple=8, **({"device": "cpu"} if index_cls is TIndex else {}))
    idx.add_video("testvid", emb[:5], [f"{i * 10}.jpg" for i in range(1, 6)])
    idx.add_video("solo", emb[5:], ["0.jpg"])
    store = store_cls()
    recs = [{"frameidx": i * 10, "frameid": f"{i * 10}.jpg", "video": "videos/testvid.mp4",
             "filepath": f"frames/{i * 10}.jpg", "tags": ["weapon"] if i == 2 else [],
             "metadata": {"caption": "a crowd fighting"} if i == 3 else {},
             "text_detections": {"detections": [{"label": "lối thoát", "confidence": 0.85}]} if i in (1, 2) else {},
             "object_detections": {"detections": [{"label": "person", "confidence": 0.8},
                                                  {"label": "knife", "confidence": 0.6}]} if i == 1 else {}}
            for i in range(1, 6)]
    store.add_video("testvid", recs, fps=25.0)
    store.add_transcript("testvid", [{"start": 0.0, "end": 1.0, "text": "chạy đi"}])
    return qe_cls(FakeEngine(), idx, store)


def test_stub_engine_edge_cases_match_jax():
    j, t = _stub((JIndex, JStore, JQE)), _stub((TIndex, TStore, TQE))
    calls = [
        ("text_clip", dict(query="fight", top_k=3)),
        ("text_clip", dict(query="fight", top_k=3, video_name="solo")),  # no metadata
        ("text_adaptive", dict(query="fight", adaptive_threshold=1.1, top_k=5)),
        ("keyword_only", dict(keyword="loi thoat", adaptive_threshold=0.9, top_k=5)),
        ("text_keyword", dict(query="fight", adaptive_threshold=0.5, top_k=5, keyword="thoat")),
        ("object_only", dict(query="person", adaptive_threshold=0.9, top_k=5)),  # cap 0.65
        ("object_only", dict(query="crowd", adaptive_threshold=0.5, top_k=5)),
        ("text_object", dict(query="danger sign", adaptive_threshold=0.0, top_k=5, object_keyword="weapon")),
        ("text_object_keyword", dict(query="fight", adaptive_threshold=0.0, top_k=5,
                                     keyword="loi", object_keyword="knife")),
        ("speech_only", dict(keyword="chay", top_k=5)),
        ("text_speech", dict(query="fight", adaptive_threshold=0.0, top_k=5, keyword="chạy")),
        ("video", dict(query="crowd", top_k=5)),
        ("text_clip", dict(query="zero", top_k=50)),  # k past the index
    ]
    for method, kwargs in calls:
        assert t.search(method, **kwargs) == j.search(method, **kwargs), (method, kwargs)
    for kwargs in (dict(queries=["fight", "danger sign"]), dict(queries=["danger sign", "fight"], max_gap=1)):
        assert t.query_temporal(**kwargs) == j.query_temporal(**kwargs)
    with pytest.raises(ValueError, match="unknown search_method"):
        t.search("nope")
    scores = np.array([[0.1, 0.9, 0.2, 0.8, 0.5], [0.3, 0.1, 0.95, 0.2, 0.4]], np.float32)
    for gap in (None, 1, 2):
        assert ttemporal.chain_dp(scores, gap) == jtemporal.chain_dp(scores, gap)
    assert ttemporal.chain_dp(scores[:, :1], None) == (float("-inf"), [])
