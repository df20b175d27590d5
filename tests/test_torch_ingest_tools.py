"""The port's ingest, export and retrieval CLIs against the JAX package's,
on the CPU, from one reference-format checkpoint of ViT-Tiny-Test params
(with a classifier head): the same artefacts, embeddings within the fp32
encode bound, the same ranked frames. The JAX ingest CLI runs with
``--local-ocr off`` (its OCR annotator is ROADMAP A17's)."""

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
    jtool.main(videos + ["--data-root", str(tmp_path / "j"), "--local-ocr", "off"] + common)
    assert out.splitlines()[-1] == capsys.readouterr().out.splitlines()[-1]
    assert _tree(tmp_path / "t") == _tree(tmp_path / "j")
    for i in range(2):
        got, ref = (np.load(tmp_path / r / "embedding" / f"v{i}_embeddings.npy") for r in "tj")
        np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    mappings = [json.loads((tmp_path / r / "metadata" / "video_mapping.json").read_text()) for r in "tj"]
    assert mappings[0] == mappings[1] and mappings[0]["v0"]["embedding_model"] == "finetuned"


def test_ingest_cli_uniform_and_refusals(tmp_path, capsys):
    from evr_tpu_torch.tools import ingest as ttool

    write_video(tmp_path / "u.mp4", n_frames=40, size=(64, 64), seed=3)
    ttool.main([str(tmp_path / "u.mp4"), "--data-root", str(tmp_path / "d"), "--device", "cpu",
                "--model", MODEL, "--uniform", "6", "--scene-threshold", "900"])
    # six sampled frames and the one scene's middle frame
    saved = sorted(int(p.stem) for p in (tmp_path / "d" / "frames" / "u").glob("*.jpg"))
    assert saved == [0, 7, 15, 20, 23, 31, 39]
    assert np.load(tmp_path / "d" / "embedding" / "u_embeddings.npy").shape == (7, 32)
    for flags in (["--zeroshot-objects"], ["--local-ocr", "on"]):
        with pytest.raises(SystemExit):
            ttool.main([str(tmp_path / "u.mp4"), "--device", "cpu"] + flags)
        assert "A17" in capsys.readouterr().err


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
