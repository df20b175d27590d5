"""The port's ingest, export and retrieval CLIs against the JAX package's,
on the CPU, from one reference-format checkpoint of ViT-Tiny-Test params
(with a classifier head): the same artefacts, embeddings within the fp32
encode bound, the same ranked frames, and the same frame metadata: both
CLIs run their OCR annotator by default (``--local-ocr auto`` with each
package's committed checkpoint), and with ``--zeroshot-objects`` their
zero-shot object annotator, whose detections must agree (labels and boxes
equal, confidences within 1e-4: OCR rounds them to 4 places, the
zero-shot softmax is fp32)."""

import json

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

import jax

from evr_tpu.models import ClassifierConfig as JClassifierConfig, init_classifier_params
from evr_tpu.models.torch_export import save_reference_checkpoint
from torch_ingest_root import ATOL, MODEL, textured, tiny_params, write_video


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    base = tmp_path_factory.mktemp("tools")
    head = jax.tree.map(np.asarray, init_classifier_params(
        jax.random.PRNGKey(8), JClassifierConfig(embed_dim=32, num_classes=3)))
    save_reference_checkpoint(base / "tiny.pt", tiny_params(6), head)
    return base / "tiny.pt"


def _tree(root):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


def _same_metadata(got_root, ref_root, name):
    """Both data roots' metadata JSON of ``name``: the same frames, fields and
    detections (the record ids are fresh uuids; the paths name each root)."""
    got, ref = (json.loads((r / "metadata" / f"{name}_metadata.json").read_text())
                for r in (got_root, ref_root))
    assert [g["frameid"] for g in got] == [r["frameid"] for r in ref]
    counts = {"text_detections": 0, "object_detections": 0}
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        for key in ("media_type", "tags", "metadata", "frameid", "frameidx"):
            assert g[key] == r[key], key
        assert g["filepath"].endswith(r["filepath"].split(str(ref_root))[-1])
        for key in counts:
            gd, rd = g[key]["detections"], r[key]["detections"]
            assert [(d["label"], d["bounding_box"]) for d in gd] == [(d["label"], d["bounding_box"]) for d in rd]
            assert all(abs(a["confidence"] - b["confidence"]) <= 1e-4 for a, b in zip(gd, rd))
            counts[key] += len(gd)
    return counts


def test_ingest_cli_matches_jax(ckpt, tmp_path, capsys):
    from evr_tpu.tools import ingest as jtool
    from evr_tpu_torch.tools import ingest as ttool

    videos = []
    for i in range(2):
        write_video(tmp_path / f"v{i}.mp4", n_frames=60, size=(96, 64), seed=10 + i)
        videos.append(str(tmp_path / f"v{i}.mp4"))
    common = ["--checkpoint", str(ckpt), "--model", MODEL]
    ttool.main(videos + ["--data-root", str(tmp_path / "t"), "--device", "cpu"] + common)
    out = capsys.readouterr().out
    jtool.main(videos + ["--data-root", str(tmp_path / "j")] + common)
    assert out.splitlines()[-1] == capsys.readouterr().out.splitlines()[-1]
    assert _tree(tmp_path / "t") == _tree(tmp_path / "j")
    for i in range(2):
        got, ref = (np.load(tmp_path / r / "embedding" / f"v{i}_embeddings.npy") for r in "tj")
        np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
        _same_metadata(tmp_path / "t", tmp_path / "j", f"v{i}")
    mappings = [json.loads((tmp_path / r / "metadata" / "video_mapping.json").read_text()) for r in "tj"]
    assert mappings[0] == mappings[1] and mappings[0]["v0"]["embedding_model"] == "finetuned"


def test_ingest_cli_uniform_and_refusals(ckpt, tmp_path):
    """``--uniform``; then the flags the port once refused (``--zeroshot-objects``,
    ``--local-ocr on``) ingest on the CPU as the JAX CLI does."""
    from evr_tpu.tools import ingest as jtool
    from evr_tpu_torch.tools import ingest as ttool

    write_video(tmp_path / "u.mp4", n_frames=40, size=(64, 64), seed=3)
    ttool.main([str(tmp_path / "u.mp4"), "--data-root", str(tmp_path / "d"), "--device", "cpu",
                "--model", MODEL, "--uniform", "6", "--scene-threshold", "900"])
    # six sampled frames and the one scene's middle frame
    saved = sorted(int(p.stem) for p in (tmp_path / "d" / "frames" / "u").glob("*.jpg"))
    assert saved == [0, 7, 15, 20, 23, 31, 39]
    assert np.load(tmp_path / "d" / "embedding" / "u_embeddings.npy").shape == (7, 32)
    video = tmp_path / "w.mp4"
    _write_text_video(video, ("fire warning", "police arrive", "exit now"))
    flags = [str(video), "--checkpoint", str(ckpt), "--model", MODEL, "--zeroshot-objects",
             "--local-ocr", "on"]
    ttool.main(flags + ["--data-root", str(tmp_path / "t"), "--device", "cpu"])
    jtool.main(flags + ["--data-root", str(tmp_path / "j")])
    counts = _same_metadata(tmp_path / "t", tmp_path / "j", "w")
    assert counts["object_detections"] > 0 and counts["text_detections"] >= 3, counts


def _write_text_video(path, words, size=(320, 180), scene_len=20):
    """An mp4v video of one flat scene a word (a hard cut between them), the
    word drawn in a DejaVu font, the OCR's training fonts."""
    from PIL import Image, ImageDraw, ImageFont

    from evr_tpu.ingest.ocr import FONT_PATHS

    font = ImageFont.truetype(FONT_PATHS[0], 30)
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 25.0, size)
    for i, word in enumerate(words):
        img = Image.new("RGB", size, ((200, 40, 40), (40, 160, 40), (40, 40, 200))[i % 3])
        ImageDraw.Draw(img).text((20, 110), word, fill=(255, 255, 255), font=font)
        frame = np.ascontiguousarray(np.asarray(img)[:, :, ::-1])
        for _ in range(scene_len):
            writer.write(frame)
    writer.release()


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    d = tmp_path_factory.mktemp("frames")
    for i in range(7):
        cv2.imwrite(str(d / f"{3 * i}.jpg"), textured(72, 96, 50 + i))
    return d


def test_export_embeddings_cli_matches_jax(ckpt, frames, tmp_path):
    from evr_tpu.tools import export_embeddings as jtool
    from evr_tpu_torch.tools import export_embeddings as ttool

    common = ["--frames-dir", str(frames), "--checkpoint", str(ckpt), "--model", MODEL,
              "--chunk-size", "3", "--batch-size", "4"]
    ttool.main(common + ["--out", str(tmp_path / "t" / "emb.npy"), "--device", "cpu"])
    jtool.main(common + ["--out", str(tmp_path / "j" / "emb.npy")])
    got, ref = (np.load(tmp_path / r / "emb.npy") for r in "tj")
    assert got.shape == (7, 32)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    names = [json.loads((tmp_path / r / "emb.names.json").read_text()) for r in "tj"]
    assert names[0] == names[1] == sorted(f"{3 * i}.jpg" for i in range(7))


@pytest.mark.parametrize("extra", [[], ["--violence-filter", "0.2", "--retrieval-mode", "classification"]])
def test_retrieve_cli_matches_jax(ckpt, frames, tmp_path, extra):
    from evr_tpu.tools import retrieve as jtool
    from evr_tpu_torch.tools import retrieve as ttool

    common = ["--frames-dir", str(frames), "--queries", "a red car", "a dark street",
              "--checkpoint", str(ckpt), "--model", MODEL, "--top-k", "4"] + extra
    ttool.main(common + ["--output", str(tmp_path / "t.json"), "--device", "cpu",
                         "--grid", str(tmp_path / "grid.png")])
    jtool.main(common + ["--output", str(tmp_path / "j.json")])
    got, ref = (json.loads((tmp_path / f"{r}.json").read_text()) for r in "tj")
    assert list(got) == list(ref)
    for query in got:
        assert [r["frame"] for r in got[query]] == [r["frame"] for r in ref[query]]
        for g, r in zip(got[query], ref[query]):
            np.testing.assert_allclose(g["similarity"], r["similarity"], atol=ATOL)
            np.testing.assert_allclose(g["class_probs"], r["class_probs"], atol=1e-5)
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        assert not (tmp_path / "grid.png").exists()
    else:
        assert (tmp_path / "grid.png").stat().st_size > 0


def test_retrieve_cli_refuses_aot_bundles(frames, capsys):
    from evr_tpu_torch.tools import retrieve as ttool

    with pytest.raises(SystemExit):
        ttool.main(["--frames-dir", str(frames), "--queries", "x", "--aot-bundle", "b", "--device", "cpu"])
    assert "A19" in capsys.readouterr().err
