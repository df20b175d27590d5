"""The port's zero-shot object annotator (``evr_tpu_torch/ingest/zeroshot.py``)
against the JAX package's, on the CPU.

The region grid, NMS and the vocabulary equal JAX's; JAX's mechanics tests
(thresholds, background margin, the cap, batch against per frame, an
undecodable frame) run on both packages with a controlled encoder (a colour
→ feature map: JAX's ``_ColourEngine`` and a torch stand-in), and the port
must give JAX's detections; ViT-Tiny-Test engines in both packages from
carried params score the same JPEG frames' staged crops (bit-equal) with the
classifier and the similarities within 1e-5 (fp32); JAX's similarities fed to
the port's ``_detect`` give JAX's detections exactly; int8 engines are held
by unit rows within the int8 tolerance; and a fresh ingest through the
port's ``ingest_video`` fills ``object_detections`` that ``query_object``
finds."""

import json
import pathlib

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

import torch

from evr_tpu.ingest import zeroshot as J
from evr_tpu_torch.ingest import zeroshot as T
from tests.test_zeroshot_annotator import _ColourEngine
from torch_ingest_root import textured, tiny_params, twin_engines
from torch_threads import one_torch_thread  # noqa: F401

SIM_TOL = 1e-5
INT8_TOL = 5e-3  # the ROADMAP's int8 tolerance (tests/test_torch_serving_int8.py)
CONF_TOL = 1e-6
COLOURS = ("red thing", "blue thing")


class _TorchColourEngine:
    """The port's stand-in of JAX's ``_ColourEngine``: a crop's feature is
    (mean R, mean B, 64) computed with torch in padded batches."""

    class _V:
        image_size = 32

    class _Cfg:
        vision = None
        embed_dim = 3

    def __init__(self):
        self.cfg = self._Cfg()
        self.cfg.vision = self._V()
        self.batch_size = 8

    def encode_texts(self, prompts, normalise=True):
        return _ColourEngine().encode_texts(prompts, normalise)

    def encode_staged_images(self, staged, normalise=False):
        outs = []
        for i in range(0, len(staged), self.batch_size):
            chunk = staged[i:i + self.batch_size]
            n = len(chunk)
            pad = np.zeros((self.batch_size - n,) + chunk.shape[1:], chunk.dtype)
            x = torch.from_numpy(np.concatenate([chunk, pad])).to(torch.float32)
            r, b = x[..., 0].mean(dim=(1, 2)), x[..., 2].mean(dim=(1, 2))
            outs.append(torch.stack([r, b, torch.full_like(r, 64.0)], -1)[:n].numpy())
        return np.concatenate(outs)


@pytest.fixture(scope="module")
def split_image(tmp_path_factory):
    p = tmp_path_factory.mktemp("zs") / "10.jpg"
    img = np.zeros((96, 96, 3), np.uint8)
    img[:, :48] = (0, 0, 255)  # BGR: left half red
    img[:, 48:] = (255, 0, 0)  # right half blue
    cv2.imwrite(str(p), img)
    return p


def _same_detections(got, ref):
    assert [(d["label"], d["bounding_box"]) for d in got] == [(d["label"], d["bounding_box"]) for d in ref]
    for g, r in zip(got, ref):
        assert set(g) == set(r) == {"label", "bounding_box", "confidence"}
        assert abs(g["confidence"] - r["confidence"]) <= CONF_TOL


def test_grid_nms_and_vocabulary_match_jax():
    assert T.COCO_CLASSES == J.COCO_CLASSES and len(T.COCO_CLASSES) == 80
    assert T.BACKGROUND_PROMPTS == J.BACKGROUND_PROMPTS
    for scales in (((1.0, 1), (0.5, 3), (1.0 / 3.0, 3)), ((0.8, 1), (0.25, 4), (0.6, 2))):
        got = T.make_region_grid(scales)
        assert got.dtype == np.float32 and np.array_equal(got, J.make_region_grid(scales))
    assert T.make_region_grid().shape == (19, 4)
    rng = np.random.default_rng(0)
    boxes = np.concatenate([rng.random((40, 2)) * 0.6, 0.1 + rng.random((40, 2)) * 0.3], 1).astype(np.float32)
    scores = rng.random(40).astype(np.float32)
    scores[5] = scores[9]  # a tie: argsort's order decides
    for iou in (0.1, 0.3, 0.5, 1.1):
        assert T.nms_xywh(boxes, scores, iou) == J.nms_xywh(boxes, scores, iou)
    assert T.nms_xywh(boxes[:3], np.array([0.9, 0.8, 0.7]), 0.5) == J.nms_xywh(boxes[:3], np.array([0.9, 0.8, 0.7]), 0.5)


MECHANICS = {
    "classes": dict(sim_threshold=0.9, bg_margin=0.0, nms_iou=0.5),
    "threshold": dict(sim_threshold=2.0),
    "background_margin": dict(sim_threshold=0.0, bg_margin=10.0),
    "cap": dict(sim_threshold=0.0, bg_margin=-10.0, nms_iou=1.1, max_detections=3),
}


@pytest.mark.parametrize("case", list(MECHANICS))
def test_detection_mechanics_match_jax(split_image, case):
    kw = MECHANICS[case]
    ref = J.ZeroShotObjectAnnotator(_ColourEngine(), classnames=COLOURS, **kw)(split_image)
    got = T.ZeroShotObjectAnnotator(_TorchColourEngine(), classnames=COLOURS, **kw)(split_image)
    assert got["text_detections"] == [] and set(got) == {"text_detections", "object_detections"}
    dets = got["object_detections"]
    _same_detections(dets, ref["object_detections"])
    if case == "classes":  # JAX's expectations, on the port's detections
        assert {d["label"] for d in dets} == set(COLOURS)
        for d in dets:
            x, _, w, _ = d["bounding_box"]
            assert (x + w / 2 < 0.5) == (d["label"] == "red thing")
        assert not any(np.allclose(d["bounding_box"], [0, 0, 1, 1]) for d in dets)
    elif case == "cap":
        assert len(dets) == 3 and dets == sorted(dets, key=lambda d: -d["confidence"])
    else:
        assert dets == []


def test_batch_matches_per_frame_and_undecodable_frames(split_image, tmp_path):
    p2 = tmp_path / "20.jpg"
    img = np.zeros((64, 64, 3), np.uint8)
    img[:] = (0, 0, 255)
    cv2.imwrite(str(p2), img)
    bad = tmp_path / "junk.jpg"
    bad.write_bytes(b"not an image")
    ann = T.ZeroShotObjectAnnotator(_TorchColourEngine(), classnames=COLOURS, sim_threshold=0.9)
    batched = ann.annotate_batch([split_image, bad, p2])
    assert batched[0] == ann(split_image) and batched[2] == ann(p2)
    assert batched[1] == {"text_detections": [], "object_detections": []}
    assert {d["label"] for d in batched[2]["object_detections"]} == {"red thing"}
    ref = J.ZeroShotObjectAnnotator(_ColourEngine(), classnames=COLOURS, sim_threshold=0.9).annotate_batch(
        [split_image, bad, p2])
    for g, r in zip(batched, ref):
        _same_detections(g["object_detections"], r["object_detections"])
    # no crop to score: the classifier is never built (no text pass)
    only_bad = T.ZeroShotObjectAnnotator(_TorchColourEngine(), classnames=COLOURS)
    assert only_bad(bad) == {"text_detections": [], "object_detections": []} and only_bad._W is None


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    d = tmp_path_factory.mktemp("zs_frames")
    paths = []
    for i, (h, w) in enumerate(((120, 160), (90, 200), (150, 110))):
        paths.append(d / f"{10 * i}.jpg")
        cv2.imwrite(str(paths[-1]), textured(h, w, 30 + i))
    return paths


def _staged_pair(jann, tann, paths):
    """Both annotators' staged crops of the same decoded frames (bit-equal)."""
    spans, staged = tann.stage_frames(paths)
    ref = np.concatenate([jann._stage_crops(np.ascontiguousarray(cv2.imread(str(p))[:, :, ::-1]))
                          for p in paths])
    assert np.array_equal(staged, ref) and [s[1] - s[0] for s in spans] == [19] * len(paths)
    return staged


def test_tiny_engines_classifier_and_sims_match_jax(frames):
    jeng, teng = twin_engines(tiny_params(4))
    classes = ("person", "car", "dog", "knife")
    jann = J.ZeroShotObjectAnnotator(jeng, classnames=classes)
    tann = T.ZeroShotObjectAnnotator(teng, classnames=classes)
    w_ref, w_got = jann._classifier(), tann._classifier()
    assert w_got.shape == (len(classes) + len(T.BACKGROUND_PROMPTS), 32) and w_got.dtype == np.float32
    np.testing.assert_allclose(w_got, w_ref, rtol=0, atol=SIM_TOL)
    staged = _staged_pair(jann, tann, frames)
    got, ref = tann._score_crops(staged), np.asarray(jann._score_crops(staged))
    assert got.shape == ref.shape == (57, len(w_ref)) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=SIM_TOL)


def test_detect_on_jax_sims_gives_jax_detections(frames):
    jeng, teng = twin_engines(tiny_params(4))
    jann = J.ZeroShotObjectAnnotator(jeng, classnames=("person", "car", "dog"))
    staged = _staged_pair(jann, T.ZeroShotObjectAnnotator(teng), frames)
    sims = np.asarray(jann._score_crops(staged))
    rng = np.random.default_rng(1)
    random_sims = rng.uniform(-0.2, 0.4, (19, 8)).astype(np.float32)
    for kw in (dict(), dict(sim_threshold=-1.0, bg_margin=-10.0), dict(sim_threshold=-1.0, bg_margin=-10.0,
                                                                      nms_iou=0.2, max_detections=40),
               dict(sim_threshold=0.0, bg_margin=0.01, temperature=30.0)):
        for region_sims, names in ((sims[:19], ("person", "car", "dog")), (sims[38:], ("person", "car", "dog")),
                                   (random_sims, ("a", "b", "c"))):
            j = J.ZeroShotObjectAnnotator(jeng, classnames=names, **kw)
            t = T.ZeroShotObjectAnnotator(teng, classnames=names, **kw)
            assert t._detect(region_sims) == j._detect(region_sims), kw


def test_int8_engine_held_by_unit_rows(frames):
    jeng, teng = twin_engines(tiny_params(4), params_dtype="int8")
    classes = ("person", "car")
    jann = J.ZeroShotObjectAnnotator(jeng, classnames=classes)
    tann = T.ZeroShotObjectAnnotator(teng, classnames=classes)
    assert teng.params["visual"]["blocks"][0]["attn"]["qkv"]["kernel_q"].dtype == torch.int8
    w_ref, w_got = jann._classifier(), tann._classifier()
    np.testing.assert_allclose(w_got, w_ref, rtol=0, atol=INT8_TOL)
    assert (w_got * w_ref).sum(1).min() >= 0.9999
    staged = _staged_pair(jann, tann, frames[:2])
    np.testing.assert_allclose(tann._score_crops(staged), np.asarray(jann._score_crops(staged)),
                               rtol=0, atol=INT8_TOL)


def test_fresh_ingest_fills_detections_and_object_search_matches(tmp_path):
    from evr_tpu_torch.config import DataRootConfig
    from evr_tpu_torch.index import EmbeddingEngine, FrameIndex, VideoRegistry
    from evr_tpu_torch.ingest import ingest_video
    from evr_tpu_torch.models.clip import CLIPConfig, TextConfig, VisionConfig
    from evr_tpu_torch.query import MetadataStore, QueryEngine

    video = tmp_path / "vid.mp4"
    writer = cv2.VideoWriter(str(video), cv2.VideoWriter_fourcc(*"mp4v"), 25.0, (64, 64))
    for i in range(40):
        frame = np.zeros((64, 64, 3), np.uint8)
        frame[:, :, 0 if i < 20 else 2] = 200
        writer.write(frame)
    writer.release()

    small = CLIPConfig(
        embed_dim=32,
        vision=VisionConfig(image_size=64, patch_size=16, width=64, layers=2, heads=4),
        text=TextConfig(width=64, layers=2, heads=4),
    )
    engine = EmbeddingEngine(cfg=small, batch_size=4, device="cpu")
    # random towers have no semantics: accept-everything thresholds prove the
    # pipeline (grid → encode → score → NMS → schema → search)
    annotator = T.ZeroShotObjectAnnotator(engine, classnames=("person", "car"), sim_threshold=-1.0,
                                          bg_margin=-10.0, max_detections=4)
    data_root = DataRootConfig(tmp_path / "data")
    index = FrameIndex(embed_dim=32, device="cpu")
    registry = VideoRegistry(tmp_path / "data" / "video_mapping.json")
    store = MetadataStore()
    result = ingest_video(video, data_root, engine, index, registry, store, annotator=annotator)
    records = json.loads(pathlib.Path(result.metadata_file).read_text())
    assert records and len(records) == result.n_frames
    for rec in records:
        dets = rec["object_detections"]["detections"]
        assert dets, "the ingest left object_detections empty"
        assert len(dets) <= 4 and all(d["label"] in ("person", "car") and len(d["bounding_box"]) == 4
                                      for d in dets)
    # random towers pick their own label: search for the first one detected
    label = records[0]["object_detections"]["detections"][0]["label"]
    events = QueryEngine(engine, index, store).query_object(label, adaptive_threshold=0.0, top_k=5)
    assert events, "object_only found nothing after zero-shot annotation"
    assert all(e["detection_type"] == "object" for e in events)
