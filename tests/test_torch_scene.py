"""The port's scene detection and frame extraction against the JAX
package's, on the CPU: content curves (float64) equal on the same
cv2-written video and on the golden MJPG fixtures (and within the golden
file's 0.05 of its recorded curves), cuts and spans equal over a threshold
grid, saved frame names and bytes equal."""

import json
import pathlib

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from evr_tpu.ingest import frames as jframes, scene as jscene
from evr_tpu_torch.ingest import frames, scene
from torch_ingest_root import write_video

GOLDEN_DIR = pathlib.Path(__file__).parent / "golden" / "scenes"


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    path = tmp_path_factory.mktemp("scene") / "cuts.mp4"
    cuts = write_video(path, n_frames=120, size=(320, 180), seed=4)
    return path, cuts


@pytest.mark.parametrize("name", ["hard_cut", "fade", "rapid_cuts"])
def test_content_curve_matches_jax_and_golden(name):
    golden = json.loads((GOLDEN_DIR / "golden.json").read_text())["videos"][name]
    cfg = scene.ContentDetectorConfig(downscale=1)
    got = scene.content_curve(GOLDEN_DIR / f"{name}.avi", cfg)
    ref = jscene.content_curve(GOLDEN_DIR / f"{name}.avi", jscene.ContentDetectorConfig(downscale=1))
    assert got.dtype == np.float64 and len(got) == golden["n_frames"]
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_allclose(got, golden["curve"], atol=0.05)
    for key, want in golden["cuts"].items():
        thr, msl = key[1:].split("_m")
        assert scene.cuts_from_curve(got, float(thr), int(msl)) == want, key


def test_auto_downscale_curve_cuts_and_spans_match_jax(video):
    path, cuts = video
    got, ref = scene.content_curve(path), jscene.content_curve(path)
    np.testing.assert_array_equal(got, ref)
    assert scene.cuts_from_curve(got, 30.0, 15) == cuts
    for thr in (10.0, 30.0, 80.0):
        for msl in (1, 15, 40):
            assert scene.cuts_from_curve(got, thr, msl) == jscene.cuts_from_curve(ref, thr, msl)
    cfg, jcfg = scene.ContentDetectorConfig(min_scene_len=30), jscene.ContentDetectorConfig(min_scene_len=30)
    spans = scene.detect_scenes(path, cfg)
    assert spans == jscene.detect_scenes(path, jcfg) and spans[0][0] == 0 and spans[-1][1] == len(got)


def test_unreadable_and_empty_videos(tmp_path):
    with pytest.raises(IOError, match="cannot open video"):
        scene.content_curve(tmp_path / "missing.mp4")
    empty = tmp_path / "empty.mp4"
    write_video(empty, n_frames=0)
    if cv2.VideoCapture(str(empty)).isOpened():
        assert scene.detect_scenes(empty) == jscene.detect_scenes(empty) == []


def _saved(d: pathlib.Path) -> dict:
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


def test_scene_frames_equal_jax(video, tmp_path):
    path, cuts = video
    got = frames.extract_scene_frames(path, tmp_path / "t")
    ref = jframes.extract_scene_frames(path, tmp_path / "j")
    assert got == ref and len(got) == len(cuts) + 1
    assert _saved(tmp_path / "t") == _saved(tmp_path / "j")
    assert sorted(_saved(tmp_path / "t")) == sorted(f"{m}.jpg" for m in got)


def test_uniform_frames_equal_jax(video, tmp_path):
    path, _ = video
    got = frames.extract_uniform_frames(path, tmp_path / "t", 7, prefix="u")
    ref = jframes.extract_uniform_frames(path, tmp_path / "j", 7, prefix="u")
    assert got == ref == [0, 19, 39, 59, 79, 99, 119]
    assert _saved(tmp_path / "t") == _saved(tmp_path / "j")
    with pytest.raises(IOError):
        frames.extract_uniform_frames(tmp_path / "missing.mp4", tmp_path / "m")
