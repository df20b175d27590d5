"""The flash-attention route (``CLIPConfig.attn_impl="flash"``) of the port
against the JAX package, end to end on the CPU.

A small geometry of ViT-H-14's shape: vision head dim 80 (W 160, 2 heads),
text head dim 64 (W 128, 2 heads, the real tokenizer's 77 positions and
vocabulary), exact GELU, two layers a tower. JAX params are drawn once and
carried across (``params_from_numpy``); inputs are made with numpy from a
seed. The JAX package runs its Pallas K6 in interpret mode (its CPU
default), the port K6's plain version (a CPU tensor). Tolerances: fp32
embeddings and scores 2e-4 (the JAX kernel tests' bound); a train step's
losses, gradient norm and gradients 5e-3 relative to the largest entry.
"""

import json

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")
pytest.importorskip("werkzeug")

import jax
import jax.numpy as jnp
from werkzeug.test import Client

from evr_tpu.config import DataRootConfig as JRoot
from evr_tpu.index import EmbeddingEngine as JEngine
from evr_tpu.index import VideoRegistry as JRegistry
from evr_tpu.models import ClassifierConfig as JClassifierConfig
from evr_tpu.models import clip as jclip
from evr_tpu.models import layers as jlayers
from evr_tpu.models.classifier import init_classifier_params as j_init_classifier
from evr_tpu.query.text import identity_preprocessor
from evr_tpu.serving import ServingContext as JContext, create_app as jcreate_app
from evr_tpu.training import TrainConfig as JTrainConfig
from evr_tpu.training import make_optimizer as j_make_optimizer
from evr_tpu.training import make_train_step as j_make_train_step
from evr_tpu.training.finetune import TrainState as JTrainState
from evr_tpu_torch.config import DataRootConfig as TRoot
from evr_tpu_torch.index import EmbeddingEngine as TEngine
from evr_tpu_torch.index import VideoRegistry as TRegistry
from evr_tpu_torch.models import clip as tclip
from evr_tpu_torch.models import layers as tlayers
from evr_tpu_torch.models.classifier import ClassifierConfig
from evr_tpu_torch.models.convert import params_from_numpy
from evr_tpu_torch.ops import attention as tattn
from evr_tpu_torch.serving import ServingContext as TContext, create_app as tcreate_app
from evr_tpu_torch.training import TrainConfig, TrainState, make_optimizer, make_train_step

ATOL = 2e-4
STEP_REL = 5e-3
EMBED = 32
VIDEOS = {"clipA": 5, "clipB": 4}
QUERIES = ["a red car", "people walking in a park"]


def _cfg(mod, impl="flash"):
    return mod.CLIPConfig(
        embed_dim=EMBED,
        vision=mod.VisionConfig(image_size=32, patch_size=8, width=160, layers=2, heads=2),
        text=mod.TextConfig(width=128, layers=2, heads=2),
        attn_impl=impl, activation="gelu",
    )


@pytest.fixture(scope="module")
def params():
    jp = jax.tree.map(np.asarray, jclip.init_clip_params(jax.random.PRNGKey(0), _cfg(jclip)))
    return jp, params_from_numpy(jp)


def _frames(n, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, 32, 32, 3), dtype=np.uint8)


def _tokens():
    from evr_tpu_torch.tokenizer import get_default_tokenizer

    return get_default_tokenizer()(QUERIES + ["", "x " * 60])


def test_encode_image_flash_matches_jax(params):
    jp, tp = params
    pixels = np.random.default_rng(1).standard_normal((3, 32, 32, 3)).astype(np.float32)
    ref = jclip.encode_image(jp, _cfg(jclip), jnp.asarray(pixels))
    got = tclip.encode_image(tp, _cfg(tclip), torch.from_numpy(pixels))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=ATOL)


def test_encode_staged_u8_flash_matches_jax(params):
    jp, tp = params
    staged = _frames(4, 2)
    ref = jclip.encode_staged_u8(jp, _cfg(jclip), jnp.asarray(staged))
    got = tclip.encode_staged_u8(tp, _cfg(tclip), torch.from_numpy(staged))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=ATOL)


def test_encode_text_eot_fast_final_flash_matches_jax(params):
    jp, tp = params
    tokens = _tokens()
    ref = jclip.encode_text(jp, _cfg(jclip), jnp.asarray(tokens), eot_fast_final=True)
    got = tclip.encode_text(tp, _cfg(tclip), torch.from_numpy(tokens), eot_fast_final=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=ATOL)


def test_flash_reaches_k6_in_every_full_block_only(params, monkeypatch):
    """Under "flash" every full block's attention goes through K6's route
    (whole-sequence for the vision tower, blocked for the causal text tower)
    and the pooled-row final blocks stay plain; "xla" never reaches K6."""
    _, tp = params
    calls = []
    for name in ("flash_attention_full", "flash_attention_blocked"):
        fn = getattr(tattn, name)
        monkeypatch.setattr(tattn, name, lambda *a, _n=name, _f=fn, **kw: calls.append(_n) or _f(*a, **kw))
    staged, tokens = torch.from_numpy(_frames(2, 3)), torch.from_numpy(_tokens())
    pixels = torch.zeros((2, 32, 32, 3))
    for impl, expected in (("flash", 1), ("xla", 0)):
        cfg = _cfg(tclip, impl)
        calls.clear()
        tclip.encode_staged_u8(tp, cfg, staged)
        assert calls == ["flash_attention_full"] * expected
        calls.clear()
        tclip.encode_text(tp, cfg, tokens, eot_fast_final=True)
        assert calls == ["flash_attention_blocked"] * expected
        calls.clear()
        tclip.encode_image(tp, cfg, pixels)  # no pooled-row block: both blocks
        assert calls == ["flash_attention_full"] * 2 * expected


@pytest.fixture(scope="module")
def engines(params):
    jp, _ = params
    j = JEngine("ViT-H-14", params=jp, cfg=_cfg(jclip), batch_size=4)
    t = TEngine("ViT-H-14", params=jp, cfg=_cfg(tclip), batch_size=4, device="cpu")
    return j, t


def test_engine_cfg_serves_the_flash_route(engines):
    j, t = engines
    assert t.cfg == _cfg(tclip) and t.cfg.attn_impl == "flash" and t.cfg.vision.width == 160
    staged = _frames(6, 4)
    np.testing.assert_allclose(t.encode_staged_images(staged), j.encode_staged_images(staged),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(t.encode_texts(QUERIES), j.encode_texts(QUERIES), rtol=0, atol=ATOL)


def _write_root(root, registry_cls, engine):
    root.ensure()
    reg = registry_cls(root.mapping_path)
    for v, (name, n) in enumerate(VIDEOS.items()):
        frames = _frames(n, 10 + v)
        writer = cv2.VideoWriter(str(root.video_dir / f"{name}.mp4"),
                                 cv2.VideoWriter_fourcc(*"mp4v"), 10.0, (32, 32))
        for f in frames:
            writer.write(f)
        writer.release()
        np.save(root.embedding_dir / f"{name}_embeddings.npy", engine.encode_staged_images(frames))
        records = [
            {"id": f"{name}-{i}", "media_type": "image", "filepath": f"frames/{name}/{i}.jpg",
             "tags": [], "metadata": {}, "video": f"videos/{name}.mp4", "frameid": f"{i}.jpg",
             "frameidx": i, "text_detections": {"detections": []},
             "object_detections": {"detections": []}}
            for i in range(n)
        ]
        (root.metadata_dir / f"{name}_metadata.json").write_text(json.dumps(records))
        reg.add(name, metadata_file=f"metadata/{name}_metadata.json",
                embeddings_file=f"embedding/{name}_embeddings.npy",
                video_path=f"videos/{name}.mp4", embedding_model="original")


def test_api_search_through_the_flash_engine_matches_jax(engines, tmp_path):
    """``ServingContext(engine=EmbeddingEngine(cfg=...))`` serves the flash
    route: the same events in the same order as the JAX app's, scores within
    the fp32 bound."""
    j, t = engines
    jroot, troot = JRoot(tmp_path / "jax"), TRoot(tmp_path / "torch")
    _write_root(jroot, JRegistry, j)
    _write_root(troot, TRegistry, t)
    jctx = JContext(jroot, engine=j, preprocessor=identity_preprocessor)
    tctx = TContext(troot, engine=t)
    assert jctx.boot() == tctx.boot() == list(VIDEOS)
    assert tctx.engine.cfg.attn_impl == "flash"
    jc, tc = Client(jcreate_app(jctx)), Client(tcreate_app(tctx))
    for q in QUERIES:
        body = {"search_type": "text", "search_method": "text_clip", "query": q, "top_k": 5}
        jr, tr = jc.post("/api/search", json=body), tc.post("/api/search", json=body)
        assert tr.status_code == jr.status_code == 200
        got = json.loads(tr.get_data(as_text=True))["events"]
        ref = json.loads(jr.get_data(as_text=True))["events"]
        assert [(e["videoId"], e["id"]) for e in got] == [(e["videoId"], e["id"]) for e in ref]
        for g, r in zip(got, ref):
            assert abs(g["clip_similarity"] - r["clip_similarity"]) <= ATOL


def _jax_mu(opt_state) -> dict:
    """optax's first moments by the port's flat keys ("clip/visual/...")."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(opt_state)[0]:
        names = [getattr(p, "name", None) for p in path]
        if "mu" not in names:
            continue
        rest = path[names.index("mu") + 1:]
        out["/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in rest)] = np.asarray(leaf)
    return out


def test_train_step_flash_matches_jax(params, monkeypatch):
    """One ``make_train_step`` step through K6 (its custom VJP in JAX, the
    ``FlashAttentionFunction`` in the port): every block of both towers runs
    K6's route forward and the plain recompute backward; the losses and the
    gradient norm, and every trainable gradient through Adam's first moment
    (after one step, (1 − b1) times the clipped gradient)."""
    jp, _ = params
    calls = []
    for name in ("flash_attention_full", "flash_attention_blocked", "xla_attention"):
        fn = getattr(tattn, name)
        monkeypatch.setattr(tattn, name, lambda *a, _n=name, _f=fn, **kw: calls.append(_n) or _f(*a, **kw))
    rng = np.random.default_rng(5)
    batch = {"images": _frames(4, 6), "tokens": _tokens()[:4],
             "labels": rng.integers(0, 3, size=4).astype(np.int32)}
    cls_np = jax.tree.map(np.asarray, j_init_classifier(jax.random.PRNGKey(1), JClassifierConfig(embed_dim=EMBED)))
    np_params = {"clip": jp, "classifier": cls_np}
    kw = dict(freeze_layers=8, batch_size=4, epochs=1, compute_dtype="float32", lr=1e-3)

    jcfg = JTrainConfig(**kw)
    jparams = jax.tree.map(jnp.asarray, np_params)
    jopt = j_make_optimizer(jcfg, jparams, steps_per_epoch=1)
    jstep, _ = j_make_train_step(_cfg(jclip), JClassifierConfig(embed_dim=EMBED, dropout=0.0), jcfg, jopt)
    jstate = JTrainState(params=jparams, opt_state=jopt.init(jparams), step=jnp.zeros((), jnp.int32))
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))

    tcfg = TrainConfig(**kw)
    tp = params_from_numpy(np_params)
    topt = make_optimizer(tcfg, tp, steps_per_epoch=1)
    tstep, _ = make_train_step(_cfg(tclip), ClassifierConfig(embed_dim=EMBED, dropout=0.0), tcfg, topt)
    tstate = TrainState(params=tp, opt_state=topt.init(tp), step=0)
    tstate, tm = tstep(tstate, batch)
    assert sorted(calls) == sorted(["flash_attention_full"] * 2 + ["flash_attention_blocked"] * 2
                                   + ["xla_attention"] * 4)

    for key in ("total_loss", "contrastive_loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=STEP_REL, err_msg=key)
    jmu, tmu = _jax_mu(jstate.opt_state), tstate.opt_state["mu"]
    assert set(tmu) == set(jmu) and any(k.startswith("clip/visual/blocks/1/") for k in tmu)
    for k, ref in jmu.items():
        got = tmu[k].numpy()
        np.testing.assert_allclose(got, ref, rtol=STEP_REL, atol=STEP_REL * np.abs(ref).max(), err_msg=k)


def test_unknown_attn_impl_raises(params):
    _, tp = params
    x = torch.zeros((1, 5, 160))
    with pytest.raises(ValueError, match="unknown attn_impl 'fast'"):
        tlayers.block_apply(x, tp["visual"]["blocks"][0], 2, attn_impl="fast")
    with pytest.raises(ValueError, match="unknown attn_impl"):
        tclip.encode_image(tp, _cfg(tclip, "sdpa"), torch.zeros((1, 32, 32, 3)))
    with pytest.raises(ValueError, match="unknown attention impl"):
        tlayers.attention(x, tp["visual"]["blocks"][0]["attn"], 2, impl="fast")


def test_auto_wider_than_1280_on_cpu_is_the_xla_math():
    """A tower wider than 1280 takes the composition under "auto"; its
    attention is "flash" only on a CUDA tensor at T >= 256, so on the CPU it
    is the "xla" math, as JAX's "auto" off the TPU."""
    W, H = 1408, 16
    jp = jax.tree.map(np.asarray, jlayers.init_block(jax.random.PRNGKey(3), W, 2))
    tp = params_from_numpy(jp)
    x = np.random.default_rng(7).standard_normal((1, 6, W)).astype(np.float32)
    ref = np.asarray(jlayers.block_apply(jnp.asarray(x), jp, H, False, "auto", "gelu"))
    got = tlayers.block_apply(torch.from_numpy(x), tp, H, False, "auto", "gelu")
    xla = tlayers.block_apply(torch.from_numpy(x), tp, H, False, "xla", "gelu")
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATOL)
    assert torch.equal(got, xla)
