"""Checkpoints in and out of the port's entry points, on the CPU:
``EmbeddingEngine.from_checkpoint`` / ``load_finetuned(prefer_ema=)`` /
``classify``, ``tools.finetune --init-checkpoint``, ``tools.index_tool query
--checkpoint`` and ``serving --checkpoint --use-ema``.

Two kinds of file: a reference ``.pt`` (written by the JAX package's
``save_reference_checkpoint``), held to the JAX engine's loading of the same
file, and the port Trainer's own ``final_checkpoint.pt`` with and without an
EMA, held to the params it was written from. ViT-Tiny-Test geometry, fp32.
"""

import contextlib
import dataclasses
import io
import json

import numpy as np
import pytest
import torch

import jax

from evr_tpu.index import EmbeddingEngine as JEngine
from evr_tpu.models import ClassifierConfig as JClassifierConfig
from evr_tpu.models import init_classifier_params as jinit_classifier
from evr_tpu.models import init_clip_params as jinit_clip
from evr_tpu.models import torch_export as jexport
from evr_tpu.models.variants import get_model_config as jget_model_config
from evr_tpu_torch.index import EmbeddingEngine
from evr_tpu_torch.models import get_model_config, params_from_numpy
from evr_tpu_torch.models.classifier import ClassifierConfig
from evr_tpu_torch.training import TrainConfig, Trainer
from tests.test_torch_ckpt_import import assert_trees_bit_equal

MODEL = "ViT-Tiny-Test"
PROB_TOL = 1e-5


@pytest.fixture(scope="module")
def trees():
    """Seeded clip params, a classifier head, and a second clip tree (the EMA)."""
    cfg = jget_model_config(MODEL)
    clip = jax.tree.map(np.asarray, jinit_clip(jax.random.PRNGKey(11), cfg))
    head = jax.tree.map(np.asarray, jinit_classifier(
        jax.random.PRNGKey(12), JClassifierConfig(embed_dim=cfg.embed_dim, num_classes=3)))
    ema = jax.tree.map(np.asarray, jinit_clip(jax.random.PRNGKey(13), cfg))
    return clip, head, ema


def write_checkpoint(path, kind: str, trees):
    """A reference file, or the port Trainer's final checkpoint (with an EMA
    tree that differs from the params for "trainer+ema")."""
    clip, head, ema = trees
    if kind == "reference":
        jexport.save_reference_checkpoint(path / "ref.pt", clip, head, epoch=2)
        return path / "ref.pt"
    tc = TrainConfig(batch_size=4, save_dir=str(path), ema_decay=0.5 if kind == "trainer+ema" else 0.0)
    cfg = get_model_config(MODEL)
    trainer = Trainer(cfg, clip, tc, classifier_params=head,
                      cls_cfg=ClassifierConfig(embed_dim=cfg.embed_dim), log_fn=lambda *_: None,
                      device="cpu")
    if kind == "trainer+ema":
        trainer.state = dataclasses.replace(trainer.state, ema_params=params_from_numpy(
            {"clip": ema, "classifier": head}))
    trainer.save_checkpoint("final_checkpoint", 0, {"val_total_loss": 1.0})
    return trainer.checkpoint_path("final_checkpoint")


@pytest.mark.parametrize("kind, prefer_ema", [
    ("reference", False), ("trainer", False), ("trainer", True), ("trainer+ema", False),
    ("trainer+ema", True),
])
def test_from_checkpoint_serves_each_kind(tmp_path, trees, kind, prefer_ema):
    clip, head, ema = trees
    path = write_checkpoint(tmp_path, kind, trees)
    engine = EmbeddingEngine.from_checkpoint(path, MODEL, prefer_ema=prefer_ema, device="cpu", batch_size=4)
    assert engine.active_model == "finetuned" and engine.available_models() == ["original", "finetuned"]
    want = ema if (kind == "trainer+ema" and prefer_ema) else clip
    got = jax.tree.map(lambda t: t.numpy(), engine.models["finetuned"]["clip"])
    assert_trees_bit_equal(got, want)
    assert_trees_bit_equal(jax.tree.map(lambda t: t.numpy(), engine.models["finetuned"]["classifier"]), head)
    staged = np.random.default_rng(0).integers(0, 256, (3, 64, 64, 3), dtype=np.uint8)
    in_memory = EmbeddingEngine(MODEL, params=want, device="cpu", batch_size=4)
    assert np.array_equal(engine.encode_staged_images(staged), in_memory.encode_staged_images(staged))
    if kind == "reference":  # the JAX engine reads the same file
        jengine = JEngine.from_checkpoint(str(path), MODEL, batch_size=4)
        assert jengine.active_model == engine.active_model
        assert_trees_bit_equal(got, jax.tree.map(np.asarray, jengine.models["finetuned"]["clip"]))


def test_classify_and_active_model_match_jax(tmp_path, trees):
    """``classify`` against the JAX engine's at 1e-5 (None without a head),
    and which model each entry point leaves active."""
    path = write_checkpoint(tmp_path, "reference", trees)
    engine = EmbeddingEngine(MODEL, device="cpu", batch_size=4)
    jengine = JEngine(MODEL, batch_size=4)
    feats = np.random.default_rng(3).normal(size=(5, 32)).astype(np.float32)
    assert engine.classify(feats) is None and jengine.classify(feats) is None  # "original" has no head
    engine.load_finetuned(path)
    jengine.load_finetuned(str(path))
    assert engine.active_model == jengine.active_model == "original"  # registered, not activated
    assert engine.set_active_model("finetuned") and jengine.set_active_model("finetuned")
    got, ref = engine.classify(feats), jengine.classify(feats)
    assert got.shape == (5, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=PROB_TOL)
    np.testing.assert_allclose(engine.classify(feats[0]), ref[:1], rtol=0, atol=PROB_TOL)
    # register_model takes the head's config as the JAX engine does
    engine.register_model("other", engine.params, engine.models["finetuned"]["classifier"],
                          ClassifierConfig(embed_dim=32, num_classes=3, dropout=0.0))
    assert engine.models["other"]["classifier_cfg"].dropout == 0.0


@pytest.mark.parametrize("what", ["directory", "moe"])
def test_unreadable_checkpoints_raise(tmp_path, trees, what):
    """A directory (an orbax checkpoint) raises. A self-describing MoE
    trainer file loads and serves: ``from_checkpoint`` builds the MoE
    engine on the file's config, whose frames equal the JAX MoE engine's on
    the same params; the dense engine's ``load_finetuned`` refuses it."""
    if what == "directory":
        with pytest.raises(NotImplementedError, match="orbax checkpoints need JAX.*torch files only"):
            EmbeddingEngine.from_checkpoint(tmp_path, MODEL, device="cpu")
        return
    from evr_tpu.models import moe as jm
    from evr_tpu_torch.models import moe as tm

    clip, head, _ = trees
    moe = tm.MoEConfig(n_experts=4, router_k=2, capacity_factor=2.0)
    tc = TrainConfig(batch_size=4, save_dir=str(tmp_path), moe=moe)
    trainer = Trainer(get_model_config(MODEL), clip, tc, classifier_params=head, log_fn=lambda *_: None,
                      device="cpu")
    trainer.save_checkpoint("final_checkpoint", 0, {})
    path = trainer.checkpoint_path("final_checkpoint")
    engine = EmbeddingEngine.from_checkpoint(path, MODEL, device="cpu", batch_size=4)
    assert engine.moe == moe and engine.active_model == "finetuned"
    served = jax.tree.map(lambda t: t.numpy(), torch.load(path, weights_only=True)["params"]["clip"])
    jengine = JEngine(MODEL, params=served, moe=jm.MoEConfig(**dataclasses.asdict(moe)), batch_size=4)
    staged = (np.random.default_rng(6).random((5, 64, 64, 3)) * 255).astype(np.uint8)
    np.testing.assert_allclose(engine.encode_staged_images(staged), jengine.encode_staged_images(staged),
                               rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="MoE checkpoint"):
        EmbeddingEngine(MODEL, device="cpu", batch_size=4).load_finetuned(path)


def test_finetune_init_checkpoint_starts_from_the_file(tmp_path):
    """The first step's loss from ``--init-checkpoint`` equals the loss from
    the same params drawn in memory: the file round-trips them exactly."""
    from evr_tpu_torch.models import init_clip_params
    from evr_tpu_torch.models.torch_export import save_reference_checkpoint
    from evr_tpu_torch.tools import finetune as cli
    from tests.test_torch_finetune import _caption_set

    captions = _caption_set(tmp_path, 5)
    save_reference_checkpoint(tmp_path / "init.pt", init_clip_params(3, get_model_config(MODEL)))
    results = {}
    for tag, extra in (("file", ["--init-checkpoint", str(tmp_path / "init.pt")]), ("memory", [])):
        results[tag] = cli.main([
            "--train-json", str(captions), "--data-dir", str(tmp_path), "--model", MODEL,
            "--device", "cpu", "--batch-size", "4", "--epochs", "1", "--seed", "3",
            "--save-dir", str(tmp_path / tag), *extra,
        ])["history"][0]
    assert results["file"]["train_batches"] == 1  # one step: its loss is the epoch's
    for key in ("train_total_loss", "train_contrastive_loss", "train_grad_norm"):
        assert results["file"][key] == results["memory"][key], key
    after = [torch.load(tmp_path / tag / "final_checkpoint.pt", weights_only=True)["params"]
             for tag in ("file", "memory")]
    assert_trees_bit_equal(*(jax.tree.map(lambda t: t.numpy(), a) for a in after))


def test_index_tool_query_checkpoint(tmp_path, trees):
    """``query --checkpoint`` encodes the queries with the fine-tuned model
    (registered and made active) and searches with them."""
    from evr_tpu_torch.index import IVFIndex
    from evr_tpu_torch.tools import index_tool

    path = write_checkpoint(tmp_path, "reference", trees)
    rows = np.random.default_rng(5).normal(size=(300, 32)).astype(np.float32)
    np.save(tmp_path / "emb.npy", rows / np.linalg.norm(rows, axis=1, keepdims=True))
    index_tool.main(["build", "--embeddings", str(tmp_path / "emb.npy"), "--type", "ivf", "--out",
                     str(tmp_path / "idx.npz"), "--clusters", "8", "--device", "cpu"])
    queries = ["a red car", "people in a park"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        index_tool.main(["query", "--index", str(tmp_path / "idx.npz"), "--type", "ivf", "--query",
                         *queries, "--model", MODEL, "--checkpoint", str(path), "--top-k", "5",
                         "--nprobe", "8", "--device", "cpu"])
    lines = [json.loads(line) for line in buf.getvalue().splitlines()]
    engine = EmbeddingEngine.from_checkpoint(path, MODEL, device="cpu")
    q = engine.encode_texts(queries)
    assert not np.allclose(q, EmbeddingEngine(MODEL, device="cpu").encode_texts(queries))
    _, want = IVFIndex.load(tmp_path / "idx.npz", device="cpu").search(q, 5, nprobe=8)
    assert len(lines) == 3 and lines[-1]["queries"] == 2
    for qi in range(2):
        assert [h["row"] for h in lines[qi]["hits"]] == [int(r) for r in want[qi] if r >= 0]


@pytest.mark.parametrize("use_ema", [False, True])
def test_serving_checkpoint_use_ema(tmp_path, monkeypatch, trees, use_ema):
    """``--checkpoint`` registers the file as "finetuned" beside "original",
    which stays active, as the JAX CLI does; ``--use-ema`` serves the EMA."""
    import werkzeug.serving

    from evr_tpu_torch.serving import __main__ as serving_cli

    clip, _, ema = trees
    path = write_checkpoint(tmp_path, "trainer+ema", trees)
    served = {}
    monkeypatch.setattr(werkzeug.serving, "run_simple", lambda host, port, app, **kw: served.update(app=app))
    serving_cli.main(["--data-root", str(tmp_path / "root"), "--device", "cpu", "--model", MODEL,
                      "--checkpoint", str(path), *(["--use-ema"] if use_ema else [])])
    engine = served["app"].ctx.engine
    assert engine.active_model == "original" and engine.available_models() == ["original", "finetuned"]
    assert_trees_bit_equal(jax.tree.map(lambda t: t.numpy(), engine.models["finetuned"]["clip"]),
                           ema if use_ema else clip)
