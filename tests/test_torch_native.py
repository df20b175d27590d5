"""The port's native frame stager and the engine's folder paths against the
JAX package's, on the CPU.

The port decodes with cv2 (whose bundled libjpeg-turbo is the same on every
host the port runs on) and resizes with its copy of the JAX package's C++
resize; the JAX stager decodes with the system libjpeg. Staged pixels must
be bit-equal on the same JPEGs (PIL and cv2 encoders, 4:2:0 and 4:4:4, grey,
down- and upscales), failed decodes reported by the same indices, and
``embed_folder`` on a folder of JPEGs (what ingest writes) within the fp32
encode bound of JAX's: the C5 check.
"""

import pathlib

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from PIL import Image

from evr_tpu.native import NativeStager as JStager, build_native as jbuild
from evr_tpu_torch.native import NativeStager, build_native
from evr_tpu_torch.native import loader
from torch_ingest_root import ATOL, textured, tiny_params, twin_engines

@pytest.fixture(scope="module")
def jax_stager():
    """The JAX package's stager, which needs g++ and libjpeg; its engine
    takes the native path only where it builds."""
    if jbuild() is None:
        pytest.skip("the JAX package's native stager cannot be built here")


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory, jax_stager):
    d = tmp_path_factory.mktemp("jpegs")
    paths = []
    for i, (h, w) in enumerate([(360, 640), (720, 1280), (300, 400), (40, 30), (224, 224)]):
        img = textured(h, w, i)
        p = d / f"{i}.jpg"
        if i % 2:
            cv2.imwrite(str(p), img[:, :, ::-1])
        else:
            Image.fromarray(img).save(p, quality=90, subsampling=0 if i == 2 else 2)
        paths.append(p)
    Image.fromarray(textured(200, 300, 9)[:, :, 0]).save(d / "grey.jpg")
    paths.append(d / "grey.jpg")
    (d / "broken.jpg").write_bytes(b"\xff\xd8 not a jpeg")
    cv2.imwrite(str(d / "png.jpg.png"), textured(64, 64, 3))
    (d / "png.jpg.png").rename(d / "png.jpg")  # a PNG under a JPEG name
    return paths + [d / "broken.jpg", d / "png.jpg", d / "missing.jpg"]


@pytest.mark.parametrize("size", [224, 64])
def test_stager_bit_equal_to_jax(jpegs, size):
    got, ok = NativeStager(size, n_threads=3).stage_batch(jpegs)
    ref, ok_ref = JStager(size).stage_batch(jpegs)
    assert ok == ok_ref == list(range(len(jpegs) - 3))
    assert got.shape == (len(jpegs), size, size, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got[ok], ref[ok])


def test_stage_pixels_takes_rgb_bgr_and_strided_rows():
    stager = NativeStager(64)
    rgb = textured(90, 120, 5)
    a, b, c = (np.empty((64, 64, 3), np.uint8) for _ in range(3))
    assert stager.stage_pixels(rgb, a, bgr=False) == 0
    assert stager.stage_pixels(np.ascontiguousarray(rgb[:, :, ::-1]), b, bgr=True) == 0
    wide = np.zeros((90, 200, 3), np.uint8)
    wide[:, :120] = rgb
    assert stager.stage_pixels(wide[:, :120], c, bgr=False) == 0  # row stride 600 bytes
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, c)
    with pytest.raises(ValueError, match="uint8"):
        stager.stage_pixels(rgb.astype(np.float32), a, bgr=False)
    empty, ok = stager.stage_batch([])
    assert empty.shape == (0, 64, 64, 3) and ok == []


def test_build_failure_raises_with_compiler_output(tmp_path, monkeypatch):
    src = tmp_path / "bad.cc"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(loader, "_SRC", src)
    monkeypatch.setattr(loader, "_BUILD", tmp_path / "build")
    with pytest.raises(RuntimeError, match="cannot build the native stager") as e:
        build_native()
    assert "bad.cc" in str(e.value) and "error" in str(e.value)
    assert not list((tmp_path / "build").iterdir())  # no half-written library
    monkeypatch.setattr(loader, "_SRC", pathlib.Path(loader.__file__).parent / "src" / "image_loader.cc")
    lib = build_native()
    assert lib.parent == tmp_path / "build" and build_native() == lib  # built once a source


@pytest.fixture(scope="module")
def engines(jax_stager):
    return twin_engines(tiny_params(1))


@pytest.fixture(scope="module")
def frame_folder(tmp_path_factory):
    """What ingest writes: cv2 JPEGs of 640 x 360 frames named {idx}.jpg,
    with one that does not decode."""
    d = tmp_path_factory.mktemp("frames")
    for i in range(7):
        cv2.imwrite(str(d / f"{10 * i + 5}.jpg"), textured(360, 640, 20 + i))
    (d / "99.jpg").write_bytes(b"broken")
    return d


def test_embed_folder_of_jpegs_matches_jax(engines, frame_folder):
    j, t = engines
    got, names = t.embed_folder(frame_folder)
    ref, ref_names = j.embed_folder(frame_folder)
    assert names == ref_names and "99.jpg" not in names and len(names) == 7
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


def test_pipelined_chunks_and_progress_match(engines, frame_folder):
    j, t = engines
    names = sorted(p.name for p in frame_folder.iterdir())
    seen = []
    got, got_names = t._embed_folder_pipelined(frame_folder, names, True, lambda d, n: seen.append((d, n)),
                                               chunk_frames=3)
    ref, ref_names = j._embed_folder_pipelined(frame_folder, names, True, None, chunk_frames=3)
    assert got_names == ref_names and seen == [(3, 8), (6, 8), (8, 8)]
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_streaming_matches_and_raises_the_producer_error(engines, frame_folder, monkeypatch):
    from evr_tpu.index.stream import embed_folder_streaming as jstream
    from evr_tpu_torch.index.stream import embed_folder_streaming

    j, t = engines
    got, names = embed_folder_streaming(t, frame_folder, batch_size=3)
    ref, ref_names = jstream(j, frame_folder, batch_size=3)
    assert names == ref_names
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)

    def boom(paths):
        raise RuntimeError("stager gone")

    monkeypatch.setattr(t, "_stage_native", boom)
    with pytest.raises(RuntimeError, match="stager gone"):
        embed_folder_streaming(t, frame_folder)


def test_engine_refuses_an_unknown_preprocess_mode():
    from evr_tpu_torch.index import EmbeddingEngine

    with pytest.raises(ValueError, match="preprocess_mode"):
        EmbeddingEngine("ViT-Tiny-Test", device="cpu", preprocess_mode="exact")
