"""SCST (``evr_tpu_torch.training.scst``), its CLI and the captioners of
data prep against ``evr_tpu`` on the CPU.

The reward CLIP is the tiny geometry of ``tests/torch_trainer_twins.py``
(text context 16, 600 ids, EOT the largest); the captioner shares its
vocabulary (SOT 598, EOT 599) and its token embedding is ×10 so greedy
steps are far from ties. fp32. Tolerances: the reward and the XE loss
1e-5; gradients and updates 5e-3 relative L2. The SCST step is held on
JAX's own sampled tokens (the port samples from a ``torch.Generator``).
"""

import dataclasses
import json

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from evr_tpu.data_prep.captioning import PrefixCaptioner as JPrefixCaptioner
from evr_tpu.index.engine import EmbeddingEngine as JEngine
from evr_tpu.models import captioner as jc
from evr_tpu.training import scst as js
from evr_tpu_torch.data_prep import HFCaptioner, PrefixCaptioner, TemplateCaptioner, caption_folder
from evr_tpu_torch.index.engine import EmbeddingEngine
from evr_tpu_torch.ingest.annotate import annotate_folder
from evr_tpu_torch.models import captioner as tc
from evr_tpu_torch.models.convert import params_from_numpy
from evr_tpu_torch.training import scst as ts
from evr_tpu_torch.training.finetune import flat_leaves

from torch_trainer_twins import assert_close_rel, cfgs, np_params, to_np, updates
from torch_threads import one_torch_thread  # noqa: F401

J_CAP = jc.CaptionerConfig(vocab_size=600, sot_id=598, eot_id=599, width=32, layers=2, heads=2, image_dim=32,
                           prefix_len=3, max_new_tokens=10)
T_CAP = tc.CaptionerConfig(**dataclasses.asdict(J_CAP))


def spread(params):
    return {**params, "token_embedding": params["token_embedding"] * 10}


@pytest.fixture(scope="module")
def setup():
    clip = np_params()["clip"]
    cap = jax.tree.map(np.asarray, spread(jc.init_captioner_params(jax.random.PRNGKey(0), J_CAP)))
    feats = np.random.default_rng(0).normal(size=(4, 32)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
    return clip, cap, feats


def caption_buffers(rng, n: int, cap) -> np.ndarray:
    toks = np.zeros((n, cap.buf_len), np.int32)
    toks[:, 0] = cap.sot_id
    for i in range(n):
        ln = int(rng.integers(2, cap.max_new_tokens))
        toks[i, 1:ln] = rng.integers(1, 590, size=ln - 1)
        toks[i, ln] = cap.eot_id
    return toks


def test_clip_text_reward_matches_jax(setup):
    """The cosine reward, clamped and ×100; a buffer longer than the text
    context is truncated with EOT last."""
    clip, _, feats = setup
    jcfg, tcfg = cfgs("auto")
    tp = params_from_numpy(clip)
    for cap in (J_CAP, dataclasses.replace(J_CAP, max_new_tokens=20)):
        toks = caption_buffers(np.random.default_rng(1), 4, cap)
        rj = js.clip_text_reward(clip, jcfg, jnp.asarray(feats), jnp.asarray(toks), eot_id=cap.eot_id)
        rt = ts.clip_text_reward(tp, tcfg, torch.from_numpy(feats), torch.from_numpy(toks).long(), eot_id=cap.eot_id)
        np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=0, atol=1e-5 * 100)
        assert (rt >= 0).all()
    assert (np.asarray(rj) == 0).any() or (np.asarray(rj) > 0).all()


def test_xe_loss_and_gradients_match_jax(setup):
    _, cap, feats = setup
    toks = caption_buffers(np.random.default_rng(2), 4, J_CAP)
    valid = np.array(js._valid_from_tokens(jnp.asarray(toks), J_CAP.eot_id))
    np.testing.assert_array_equal(ts._valid_from_tokens(torch.from_numpy(toks), 599).numpy(), valid)
    lj, gj = jax.jit(jax.value_and_grad(lambda p, f, t, v: js.xe_caption_loss(p, J_CAP, f, t, v)))(
        cap, feats, toks, valid)
    lt, gt = ts.value_and_grads(lambda p: ts.xe_caption_loss(p, T_CAP, torch.from_numpy(feats),
                                                             torch.from_numpy(toks), torch.from_numpy(valid)),
                                params_from_numpy(cap))
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    assert assert_close_rel(to_np(gt), to_np(gj), what="xe") > 20


def test_scst_step_on_jax_sampled_tokens(setup):
    """One step: JAX's sampled rollout (its step key) handed to the port's
    step; the greedy rollouts, both rewards, the loss and the update of
    every leaf against JAX's ``make_scst_step``."""
    clip, cap, feats = setup
    jcfg, tcfg = cfgs("auto")
    cfg = js.ScstConfig(lr=1e-3, advantage_scale=1.0)
    opt = optax.apply_if_finite(optax.chain(optax.clip_by_global_norm(cfg.grad_clip),
                                            optax.adamw(cfg.lr, weight_decay=cfg.weight_decay)), 10)
    jcap = jax.tree.map(jnp.asarray, cap)
    key = jax.random.PRNGKey(5)
    sampled = jax.jit(lambda p, f, k: jc.generate(p, J_CAP, f, rng=k, sample=True, temperature=cfg.temperature,
                                                  top_k=cfg.top_k, top_p=cfg.top_p))(jcap, feats, key)
    jparams, _, jm = js.make_scst_step(J_CAP, jcfg, cfg, opt)(jcap, opt.init(jcap), clip, jnp.asarray(feats), key)
    tcfg_s = ts.ScstConfig(**dataclasses.asdict(cfg))
    topt = ts.ScstOptimizer(tcfg_s)
    tparams = params_from_numpy(cap)
    state = topt.init(tparams)
    tm = ts.make_scst_step(T_CAP, tcfg, tcfg_s, topt)(
        tparams, state, params_from_numpy(clip), torch.from_numpy(feats),
        sampled=(torch.from_numpy(np.array(sampled[0])).long(), torch.from_numpy(np.array(sampled[1]))))
    for k in ("reward_sample", "reward_greedy", "advantage"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=0, atol=1e-3, err_msg=k)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4, atol=1e-5)
    assert abs(float(jm["advantage"])) > 1e-3  # the step moves the captioner
    assert state["inner"]["count"] == 1
    assert assert_close_rel(updates(to_np(tparams), to_np(cap)), updates(to_np(jparams), to_np(cap)),
                            what="scst update") > 20


def test_encode_captions_matches_jax():
    caps = ["a man runs across the street", "two cars", "x " * 40]
    got = ts.encode_captions(caps, T_CAP)
    np.testing.assert_array_equal(got, js.encode_captions(caps, J_CAP))
    assert got.shape == (3, T_CAP.buf_len) and (got[:, 0] == 598).all() and got[2, -1] == 599


def test_trainer_fit_checkpoints_and_early_stop(setup, tmp_path):
    """XE warm start, then SCST epochs that stop once the validation reward
    reaches the target; per-epoch and final checkpoints; a restored
    checkpoint holds the params it saved."""
    clip, cap, feats = setup
    tcfg = cfgs("auto")[1]
    cfg = ts.ScstConfig(batch_size=2, target_reward=0.0, save_dir=str(tmp_path))
    trainer = ts.ScstTrainer(clip, tcfg, T_CAP, cfg, params=cap, device="cpu")
    losses = trainer.pretrain_xe(feats, caption_buffers(np.random.default_rng(3), 4, T_CAP), epochs=2)
    assert len(losses) == 4 and np.isfinite(losses).all()
    history = trainer.fit(feats, val_features=feats[:2], epochs=3, save_checkpoints=True)
    assert len(history) == 1 and history[0]["val_reward"] >= 0.0  # the target is met at once
    assert sorted(p.name for p in tmp_path.iterdir()) == ["scst_epoch1.pt", "scst_final.pt"]
    before = {k: v.clone() for k, v in flat_leaves(trainer.params).items()}
    trainer.params = params_from_numpy(cap)
    trainer.restore_checkpoint("scst_final")
    for k, v in flat_leaves(trainer.params).items():
        assert torch.equal(v, before[k]), k
    loaded = flat_leaves(ts.load_captioner(tmp_path / "scst_final.pt", device="cpu"))
    assert all(torch.equal(loaded[k], before[k]) for k in before)


def test_cli_trains_and_refuses_an_overlong_caption(tmp_path, capsys):
    from evr_tpu_torch.tools import train_captioner as cli

    rng = np.random.default_rng(4)
    np.save(tmp_path / "e.npy", rng.normal(size=(10, 32)).astype(np.float32))
    (tmp_path / "c.json").write_text(json.dumps([f"a frame number {i}" for i in range(10)]))
    common = ["--embeddings", str(tmp_path / "e.npy"), "--model", "ViT-Tiny-Test", "--device", "cpu",
              "--cap-width", "32", "--cap-layers", "1", "--cap-heads", "2", "--prefix-len", "2"]
    with pytest.raises(SystemExit, match="overflows the reward tower's 77-token context"):
        cli.main(common + ["--max-new-tokens", "77"])
    history = cli.main(common + ["--captions", str(tmp_path / "c.json"), "--xe-epochs", "1", "--scst-epochs", "2",
                                 "--batch-size", "4", "--max-new-tokens", "6", "--save-dir", str(tmp_path / "s"),
                                 "--demo", "2", "--beam-size", "2"])
    out = capsys.readouterr().out
    assert "XE warm start: loss" in out and "demo[1]:" in out and len(history) in (1, 2)
    assert (tmp_path / "s" / "scst_final.pt").exists() and (tmp_path / "s" / "scst_epoch1.pt").exists()
    assert json.loads((tmp_path / "s" / "history.json").read_text()) == history


class IdWords:
    """A tokenizer that spells each id (``t<id>``): the machine's fallback
    vocabulary spells most of a random captioner's ids as one replacement
    character, which would make every frame's caption alike."""

    def decode(self, ids):
        return " ".join(f"t{i}" for i in ids)


def test_prefix_captioner_through_annotate_folder(setup, tmp_path):
    """``annotate_folder(captioner=PrefixCaptioner)`` writes each frame's
    caption into its record, in frame order; the captions equal the JAX
    PrefixCaptioner's over the same frames, CLIP params and captioner
    params, and differ between frames."""
    import cv2

    clip, _, _ = setup
    jcfg, tcfg = cfgs("auto")
    cap_j = dataclasses.replace(jc.CaptionerConfig(), width=32, layers=1, heads=2, image_dim=32, prefix_len=2,
                                max_new_tokens=6)
    cap = jax.tree.map(np.array, spread(jc.init_captioner_params(jax.random.PRNGKey(1), cap_j)))
    rng = np.random.default_rng(5)
    for i in range(5):
        cv2.imwrite(str(tmp_path / f"{i * 30}.jpg"), (rng.random((40, 48, 3)) * 255).astype(np.uint8))
    engine = EmbeddingEngine(cfg=tcfg, params=clip, device="cpu", batch_size=4)
    captioner = PrefixCaptioner(engine, cap, tc.CaptionerConfig(**dataclasses.asdict(cap_j)), tokenizer=IdWords())
    records = annotate_folder(tmp_path, "v.mp4", captioner=captioner)
    got = [r["metadata"]["caption"] for r in records]
    assert [r["frameid"] for r in records] == ["0.jpg", "120.jpg", "30.jpg", "60.jpg", "90.jpg"]
    assert len(got) == 5 and len(set(got)) >= 3
    paths = sorted(str(p) for p in tmp_path.glob("*.jpg"))
    assert captioner.caption_batch(paths) == got
    jengine = JEngine(cfg=jcfg, params=jax.tree.map(jnp.asarray, clip), batch_size=4)
    jcap = JPrefixCaptioner(jengine, jax.tree.map(jnp.asarray, cap), cap_j, tokenizer=IdWords())
    assert jcap.caption_batch(paths) == got


def test_template_folder_and_hf_captioner_refusal(tmp_path, monkeypatch):
    """``caption_folder`` with the template captioner resumes a partial
    file; ``HFCaptioner`` raises when the model is not on this machine
    (nothing is fetched), and without a card unless asked for the CPU."""
    for name in ("a_b.jpg", "c.png", "skip.txt"):
        (tmp_path / name).write_bytes(b"x")
    out = tmp_path / "caps.json"
    out.write_text(json.dumps({"a_b.jpg": {"caption": "kept", "category": "Violence"}}))
    res = caption_folder(tmp_path, out, category="Violence")
    assert res == {"a_b.jpg": {"caption": "kept", "category": "Violence"},
                   "c.png": {"caption": TemplateCaptioner()("c.png", "Violence"), "category": "Violence"}}
    assert json.loads(out.read_text()) == res
    with pytest.raises(Exception, match="(?i)local|cache|offline|not found|snapshot"):
        HFCaptioner("evr-test/no-such-captioner-model", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)  # the card by default: none, so it refuses
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HFCaptioner("evr-test/no-such-captioner-model")
