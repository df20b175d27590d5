"""The port's ingest pipeline against the JAX package's, on the CPU.

Twin data roots, the same cv2-written video, the same ViT-Tiny-Test params:
embeddings within the fp32 encode bound, metadata records equal except
``id`` and the paths, registry entries equal, the progress stages in the
same order, the live index and metadata store updated; the annotators'
batch preference and skip-on-error; transcripts through the port's
``read_wav``; best-frame selection.
"""

import json
import pathlib
import wave

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from evr_tpu.config import DataRootConfig as JRoot
from evr_tpu.index import FrameIndex as JIndex, VideoRegistry as JRegistry
from evr_tpu.ingest import annotate as jannotate, best_frame as jbest, pipeline as jpipeline
from evr_tpu.ingest import transcripts as jtranscripts
from evr_tpu.models.whisper import read_wav as jread_wav
from evr_tpu.query import MetadataStore as JStore
from evr_tpu_torch.config import DataRootConfig
from evr_tpu_torch.index import FrameIndex, VideoRegistry
from evr_tpu_torch.ingest import annotate, annotators, best_frame, pipeline, transcripts
from evr_tpu_torch.query.metadata import MetadataStore
from torch_ingest_root import ATOL, tiny_params, twin_engines, write_video


@pytest.fixture(scope="module")
def engines():
    return twin_engines(tiny_params(3))


def _strip(records, root):
    """Records without their uuid, with paths relative to their root."""
    out = []
    for r in records:
        r = {k: v for k, v in r.items() if k != "id"}
        r["filepath"] = str(r["filepath"]).replace(str(root), "ROOT")
        r["video"] = str(r["video"]).replace(str(root), "ROOT")
        out.append(r)
    return out


@pytest.fixture(scope="module")
def ingested(engines, tmp_path_factory):
    base = tmp_path_factory.mktemp("ingest")
    j, t = engines
    video = base / "clip.mp4"
    write_video(video, n_frames=90, size=(128, 72), seed=7)
    runs = {}
    for tag, engine, Root, Index, Registry, Store, ingest in (
        ("jax", j, JRoot, JIndex, JRegistry, JStore, jpipeline.ingest_video),
        ("torch", t, DataRootConfig, FrameIndex, VideoRegistry, MetadataStore, pipeline.ingest_video),
    ):
        root = Root(base / tag).ensure()
        kwargs = {"device": "cpu"} if tag == "torch" else {}
        index, registry, store = Index(embed_dim=32, **kwargs), Registry(root.mapping_path), Store()
        stages = []
        result = ingest(video, root, engine, index=index, registry=registry, metadata_store=store,
                        progress=lambda *a, s=stages: s.append(a))
        runs[tag] = dict(root=root, result=result, index=index, registry=registry, store=store,
                         stages=stages)
    return runs


def test_ingest_video_matches_jax(ingested):
    j, t = ingested["jax"], ingested["torch"]
    assert t["result"].n_frames == j["result"].n_frames == 4
    assert t["result"].fps == j["result"].fps == 25.0
    got, ref = np.load(t["result"].embeddings_file), np.load(j["result"].embeddings_file)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    meta = [json.loads(open(r["result"].metadata_file).read()) for r in (t, j)]
    assert _strip(meta[0], t["root"].root) == _strip(meta[1], j["root"].root)
    assert t["stages"] == j["stages"]
    assert [s[0] for s in t["stages"]][:2] == ["scene_detect", "embedding"]
    assert t["stages"][-2:] == [("annotating", 0, 4), ("registering", 4, 4)]


def test_registry_and_live_state_match_jax(ingested):
    j, t = ingested["jax"], ingested["torch"]
    entry = t["registry"].get("clip")
    assert entry == j["registry"].get("clip")
    assert entry["embeddings_file"] == "embedding/clip_embeddings.npy"
    assert json.loads(t["root"].mapping_path.read_text()) == json.loads(j["root"].mapping_path.read_text())
    assert t["index"].total_frames == j["index"].total_frames == 4
    assert t["index"].videos == j["index"].videos
    assert len(t["store"].frames("clip")) == 4 and t["store"].fps("clip") == 25.0


def test_annotate_folder_prefers_batches_and_skips_failures(ingested, tmp_path):
    frames_dir = ingested["torch"]["result"].frames_dir

    failing = sorted(p.stem for p in pathlib.Path(frames_dir).iterdir())[1]

    class Batched:
        def __init__(self, fail_batch=False):
            self.fail_batch, self.batches, self.calls = fail_batch, 0, 0

        def annotate_batch(self, paths):
            self.batches += 1
            if self.fail_batch:
                raise RuntimeError("batch failed")
            return [{"text_detections": [{"label": p.stem, "bounding_box": [0, 0, 1, 1],
                                          "confidence": 0.5}], "object_detections": []} for p in paths]

        def __call__(self, path):
            self.calls += 1
            if path.stem == failing:
                raise RuntimeError("frame failed")
            return {"text_detections": [], "object_detections": [{"label": "car",
                    "bounding_box": [0, 0, 1, 1], "confidence": 0.9}]}

    class Captioner:
        def caption_batch(self, paths):
            raise RuntimeError("batch captioning failed")

        def __call__(self, path):
            return f"frame {path.stem}"

    for fail in (False, True):
        got_ann, ref_ann = Batched(fail), Batched(fail)
        got = annotate.annotate_folder(frames_dir, "v.mp4", got_ann, captioner=Captioner())
        ref = jannotate.annotate_folder(frames_dir, "v.mp4", ref_ann, captioner=Captioner())
        assert _strip(got, "") == _strip(ref, "")
        assert (got_ann.batches, got_ann.calls) == (ref_ann.batches, ref_ann.calls)
        assert all(r["metadata"]["caption"] == f"frame {r['frameidx']}" for r in got)
    assert len(got) == len(ref) == 3  # one frame raised in the per-frame fallback
    from evr_tpu.ingest.annotators import CompositeAnnotator as JComposite

    paths = sorted(pathlib.Path(frames_dir).iterdir())
    got = annotators.CompositeAnnotator(Batched(), annotate.NullAnnotator(), Batched())
    ref = JComposite(Batched(), jannotate.NullAnnotator(), Batched())
    assert got.annotate_batch(paths) == ref.annotate_batch(paths)
    assert got(paths[0]) == ref(paths[0]) and len(got(paths[0])["object_detections"]) == 2
    for cls in (annotators.EasyOCRAnnotator, annotators.YOLOAnnotator):
        with pytest.raises(ImportError, match="optional host-side plugin"):
            cls()


def _write_wav(path, x, rate, width, channels):
    scale = {1: 127, 2: 32767, 4: 2147483647}[width]
    ints = np.round(np.repeat(x[:, None], channels, axis=1) * scale).astype({1: np.int16, 2: np.int16, 4: np.int32}[width])
    if width == 1:
        ints = (ints + 128).astype(np.uint8)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(rate)
        w.writeframes(ints.tobytes())


@pytest.mark.parametrize("rate,width,channels", [(16000, 2, 1), (22050, 1, 2), (8000, 4, 1)])
def test_transcripts_round_trip_through_read_wav(tmp_path, rate, width, channels):
    x = 0.5 * np.sin(np.arange(rate // 2) / 7.0)
    path = tmp_path / "a.wav"
    _write_wav(path, x, rate, width, channels)
    got = transcripts.read_wav(path)
    np.testing.assert_array_equal(got, jread_wav(str(path)))
    assert got.dtype == np.float32 and len(got) == 8000

    class ASR:
        def transcribe_segments(self, audio, prompt_ids=None):
            return [{"start": 0, "end": len(audio) / 16000, "text": f" heard {prompt_ids} "},
                    {"start": 1, "end": 2, "text": "  "}]

    out = tmp_path / "meta" / "clip_transcript.json"
    payload = transcripts.build_video_transcript(
        path, "clip", transcripts.WhisperSegmentTranscriber(ASR(), [7]), out_path=out)
    ref = jtranscripts.build_video_transcript(
        path, "clip", jtranscripts.WhisperSegmentTranscriber(ASR(), [7]))
    assert payload == ref == {"video": "clip", "segments": [{"start": 0.0, "end": 0.5, "text": "heard [7]"}]}
    assert transcripts.transcript_path_for(tmp_path / "meta" / "clip_metadata.json", "clip") == out
    assert transcripts.load_transcript(out) == payload["segments"]


def test_best_frames_match_jax(engines, ingested):
    j, t = engines
    frames_dir = ingested["torch"]["result"].frames_dir
    captions = ["a red square", "a dark room", "two people"]
    got = best_frame.select_best_frames(t, frames_dir, captions)
    ref = jbest.select_best_frames(j, frames_dir, captions)
    assert [g["frame"] for g in got] == [r["frame"] for r in ref]
    np.testing.assert_allclose([g["similarity"] for g in got], [r["similarity"] for r in ref], atol=ATOL)
    mapping = best_frame.build_frame_caption_mapping(t, {"c": (frames_dir, captions[:1])})
    assert list(mapping) == [f"c/{got[0]['frame']}"]
