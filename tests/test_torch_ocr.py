"""The port's OCR (``evr_tpu_torch/ingest/ocr.py``) against the JAX
package's, on the CPU, from the same numpy inputs: the host parts (labels,
synthetic renders, line staging, the text-line detector, greedy CTC decode)
bit-equal; the checkpoint copy equal to JAX's file; the recogniser's fp32
logits within atol 1e-4 / rtol 1e-5 (XLA's and oneDNN's convolutions sum in
different orders; the committed checkpoint's logits reach about 260) on the
committed checkpoint and on a JAX random init carried across; the annotator
on JPEG frames with JAX's labels and boxes and confidences within 1e-4; then
the seeded-frame keyword search through the port's ``QueryEngine`` and the
checkpoint's held-out accuracy."""

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

import jax
import torch

from evr_tpu.ingest import ocr as J
from evr_tpu_torch.ingest import ocr as T
from torch_threads import one_torch_thread  # noqa: F401

LOGIT_TOL = dict(rtol=1e-5, atol=1e-4)
CONF_TOL = 1e-4
CONF_MARGIN = 1e-3  # the frames' confidences sit this far from min_conf at least


def _frame_with_text(text, size=(640, 360), pos=(80, 300), font_size=30, fg=255, bg=30):
    from PIL import Image, ImageDraw, ImageFont

    img = Image.new("L", size, bg)
    font = ImageFont.truetype(J.FONT_PATHS[0], font_size)
    ImageDraw.Draw(img).text(pos, text, fill=fg, font=font)
    return np.asarray(img, np.uint8)


def _scene(text, rng, font_size=36):
    """Text over a smooth scene-like background (blurred noise from ``rng``)."""
    base = cv2.GaussianBlur(rng.integers(10, 90, (360, 640)).astype(np.uint8), (31, 31), 0)
    return np.maximum(base, _frame_with_text(text, font_size=font_size))


def _save_jpeg(path, gray):
    from PIL import Image

    Image.fromarray(gray).save(path, quality=95)
    return path


def test_labels_charset_and_lexicon_match_jax():
    assert T.CHARSET == J.CHARSET and T.BLANK_ID == J.BLANK_ID and T.N_CLASSES == J.N_CLASSES
    assert T.LEXICON_WORDS == J.LEXICON_WORDS and T.FONT_PATHS == J.FONT_PATHS
    assert (T.IMG_H, T.IMG_W, T.MAX_LABEL) == (J.IMG_H, J.IMG_W, J.MAX_LABEL)
    for text in ("fire 123", "Cảnh SÁT đêm", "a☃b", "", "LỐI THOÁT hiểm!"):
        assert T.encode_label(text) == J.encode_label(text)
        assert T.decode_ids(T.encode_label(text)) == J.decode_ids(J.encode_label(text))
    assert T.decode_ids([0, 5, 200, 112, 111]) == J.decode_ids([0, 5, 200, 112, 111])
    rj, rt = np.random.default_rng(4), np.random.default_rng(4)
    assert [T.sample_text(rt) for _ in range(200)] == [J.sample_text(rj) for _ in range(200)]


def test_make_dataset_bit_equal():
    got, ref = T.make_dataset(24, seed=3), J.make_dataset(24, seed=3)
    for g, r in zip(got[:3], ref[:3]):
        assert g.dtype == r.dtype and np.array_equal(g, r)
    assert got[3] == ref[3]


def test_stage_crop_bit_equal():
    rng = np.random.default_rng(7)
    for h, w in ((12, 40), (32, 256), (64, 900), (80, 30), (5, 300)):
        crop = rng.random((h, w)).astype(np.float32)
        assert np.array_equal(T.stage_crop(crop), J.stage_crop(crop))
        got = T.stage_crop(crop, np.random.default_rng(h * w))
        assert np.array_equal(got, J.stage_crop(crop, np.random.default_rng(h * w)))


def test_detect_text_regions_bit_equal():
    bright = _frame_with_text("breaking news tonight")
    dark = _frame_with_text("breaking news tonight", fg=20, bg=220)  # the other polarity
    flat = np.full((360, 640), 128, np.uint8)
    for frame in (bright, dark, flat):
        got = T.detect_text_regions(frame)
        assert got == J.detect_text_regions(frame)
        assert (got == []) == (frame is flat)
        assert T.detect_text_regions(frame, max_regions=1) == J.detect_text_regions(frame, max_regions=1)


def test_ctc_greedy_decode_equal():
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 4, (5, 64, T.N_CLASSES)).astype(np.float32)
    logits[1, :, T.BLANK_ID] += 30.0  # all blank: empty text, confidence 0
    a, b = T.encode_label("a")[0], T.encode_label("b")[0]
    for t, cls in enumerate([0, a, a, 0, b, b, 0, a]):
        logits[2, t, cls] += 40.0
    got, ref = T.ctc_greedy_decode(logits), J.ctc_greedy_decode(logits)
    assert got[0] == ref[0] and got[0][1] == "" and got[0][2].startswith("ab")
    assert got[1].dtype == ref[1].dtype and np.array_equal(got[1], ref[1])


def test_checkpoint_copy_equals_jax():
    assert T.DEFAULT_CHECKPOINT.read_bytes() == J.DEFAULT_CHECKPOINT.read_bytes()
    got, ref = T.load_checkpoint(), J.load_checkpoint()
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == torch.float32 and np.array_equal(got[k].numpy(), np.asarray(ref[k]))


@pytest.mark.parametrize("params", ["checkpoint", "random_init"])
def test_ocr_logits_match_jax(params):
    jp = J.load_checkpoint() if params == "checkpoint" else J.init_ocr_params(jax.random.PRNGKey(3))
    imgs = J.make_dataset(12, seed=11)[0]
    ref = np.asarray(J.ocr_logits(jp, jax.numpy.asarray(imgs)))
    tp = T.params_to({k: np.asarray(v) for k, v in jp.items()}, "cpu")
    got = T.ocr_logits(tp, torch.from_numpy(imgs)).numpy()
    assert got.shape == (12, 64, T.N_CLASSES) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, **LOGIT_TOL)
    # the tail batch is padded with zero crops; its real rows do not see them
    tail = T._batched_logits(tp, imgs, batch=8)
    np.testing.assert_allclose(tail, got, rtol=0, atol=1e-5)


def test_annotator_on_jpeg_frames_matches_jax(tmp_path):
    texts = ("fire on the street", "police arrive", "breaking news")
    rng = np.random.default_rng(1)
    paths = [_save_jpeg(tmp_path / f"{10 * i}.jpg", _scene(t, rng, font_size=34 + 2 * i))
             for i, t in enumerate(texts)]
    paths.append(_save_jpeg(tmp_path / "99.jpg", np.full((360, 640), 90, np.uint8)))
    (tmp_path / "junk.jpg").write_bytes(b"not an image")
    paths.append(tmp_path / "junk.jpg")
    jann = J.LocalOCRAnnotator()
    tann = T.LocalOCRAnnotator(device="cpu")
    assert tann.params["conv0_w"].device.type == "cpu"
    ref, got = jann.annotate_batch(paths), tann.annotate_batch(paths)
    assert len(got) == len(ref) == len(paths)
    assert got[-2:] == ref[-2:] == [{"text_detections": [], "object_detections": []}] * 2
    for g, r, text in zip(got, ref, texts):
        assert g["object_detections"] == [] and r["text_detections"], text
        assert [d["label"] for d in g["text_detections"]] == [d["label"] for d in r["text_detections"]]
        assert [d["bounding_box"] for d in g["text_detections"]] == \
            [d["bounding_box"] for d in r["text_detections"]]
        for gd, rd in zip(g["text_detections"], r["text_detections"]):
            assert abs(gd["confidence"] - rd["confidence"]) <= CONF_TOL
        assert text.split()[0] in " ".join(d["label"] for d in g["text_detections"])
    # every decode the thresholds judged (emitted or not) sits far from them
    _, crops = tann.frame_crops(paths)
    dec = J.ctc_greedy_decode(J._batched_logits(jann.params, crops))
    assert all(abs(c - tann.min_conf) > CONF_MARGIN for c in dec[1])
    assert T.ctc_greedy_decode(T._batched_logits(tann.params, crops))[0] == dec[0]
    assert tann(paths[0]) == got[0]


def test_keyword_search_finds_ocr_seeded_frames(tmp_path):
    from evr_tpu_torch.index import FrameIndex
    from evr_tpu_torch.ingest.annotate import annotate_folder
    from evr_tpu_torch.query import MetadataStore, QueryEngine

    from tests.test_query import FakeEngine

    frames = tmp_path / "frames"
    frames.mkdir()
    words = {0: "police arrive", 40: "quiet morning", 80: "fire warning"}
    rng = np.random.default_rng(0)
    for idx, text in words.items():
        _save_jpeg(frames / f"{idx}.jpg", _scene(text, rng))
    records = annotate_folder(frames, "video.mp4", annotator=T.LocalOCRAnnotator(device="cpu"))
    assert len(records) == 3
    assert all(r["text_detections"]["detections"] for r in records), "text_detections left empty"

    store = MetadataStore()
    store.add_video("vid", records, fps=25.0)
    fake = FakeEngine(dim=8)
    fake.register("fire", 2)
    emb = np.zeros((3, 8), np.float32)
    emb[2, 2] = 1.0  # frame 80 ("fire warning") along the "fire" direction
    emb[0, 1] = emb[1, 3] = 1.0
    index = FrameIndex(embed_dim=8, pad_multiple=8, device="cpu")
    index.add_video("vid", emb, [f"{i}.jpg" for i in sorted(words)])
    engine = QueryEngine(fake, index, store)
    hits = engine.query_keyword("police", adaptive_threshold=0.3, top_k=5)
    assert [h["id"] for h in hits] == ["event-0"]
    hits = engine.query_keyword("fire", adaptive_threshold=0.3, top_k=5)
    assert [h["id"] for h in hits] == ["event-80"]
    hits = engine.query_text_keyword("fire", adaptive_threshold=0.5, top_k=5, keyword="fire",
                                     text_confidence=0.3)
    assert [h["id"] for h in hits] == ["event-80"] and hits[0]["detection_type"] == "text+clip"


def test_checkpoint_reads_fresh_renders():
    acc = T.eval_ocr(T.load_checkpoint(), n=64, seed=20260820)
    assert acc >= 0.7, f"held-out exact-match accuracy {acc}"
    assert acc == J.eval_ocr(J.load_checkpoint(), n=64, seed=20260820)
