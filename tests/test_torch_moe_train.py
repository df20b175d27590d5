"""The trainer's MoE lever and expert parallelism against ``evr_tpu`` on the
CPU: the first step of ``Trainer(moe=)`` against the JAX Trainer's on
carried params, the (data 2, expert 4) slot mesh against one device (the
token exchange of ``parallel.ep`` counted), token groups that cross the
slots' row boundary against one device and JAX, the EMA sharded like the
params, patch drop with MoE (JAX's keep masks handed over), the refusals
the JAX trainer makes (LoRA, GradCache, FSDP with an expert axis), the CLI
flags, a trainer checkpoint served by ``EmbeddingEngine`` against the
JAX engine on the same params, and the serving CLI's engine built from an
MoE file and a dense one.

Tiny geometry of ``tests/torch_trainer_twins.py`` (T 17 and 16, W 64);
4 experts, top-2, the last block of each tower sparse; the JAX package
upcycles the dense params and seeded noise makes the experts distinct, so
routing matters. fp32, classifier dropout 0. Tolerances: loss and aux
1e-5, gradients and updates 5e-3 relative L2 against JAX; the mesh's
gradients 1e-5 relative L2 against one device.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from evr_tpu.index.engine import EmbeddingEngine as JEngine
from evr_tpu.models import moe as jm
from evr_tpu.training import Trainer as JTrainer
from evr_tpu.training import TrainConfig as JTrainConfig
from evr_tpu_torch.index.engine import EmbeddingEngine, load_torch_checkpoint
from evr_tpu_torch.models import moe as tm
from evr_tpu_torch.parallel import ep, get_mesh
from evr_tpu_torch.parallel.fsdp import ShardedTensor
from evr_tpu_torch.training import Trainer, TrainConfig
from evr_tpu_torch.training import finetune as tf

from torch_trainer_twins import (
    JCLS, TCLS, assert_close_rel, cfgs, jax_gradients, port_gradients, tiny_batch, to_np, updates,
)
from torch_threads import one_torch_thread  # noqa: F401

MOE_J = jm.MoEConfig(n_experts=4, router_k=2, capacity_factor=1.25, moe_every=2, group_size=32)
MOE_T = tm.MoEConfig(**dataclasses.asdict(MOE_J))
STEP = dict(lr=1e-3, batch_size=8, epochs=2, compute_dtype="float32", freeze_layers=0)
QUIET = dict(log_fn=lambda *_: None)


def upcycled(params: dict, jcfg) -> dict:
    """Dense numpy params upcycled by the JAX package, each expert's
    kernels moved by seeded noise (a quarter of their scale), the routers
    sharpened."""
    up = jax.tree.map(np.asarray, jm.upcycle_clip_params(jax.random.PRNGKey(7), params["clip"], jcfg, MOE_J))
    rng = np.random.default_rng(11)
    for tower in ("visual", "text"):
        for block in up[tower]["blocks"]:
            if "moe" in block:
                for a in ("fc", "proj"):
                    k = block["moe"][a]["kernel"]
                    block["moe"][a]["kernel"] = (k + 0.25 * k.std() * rng.standard_normal(k.shape)).astype(np.float32)
                block["moe"]["router"]["kernel"] = block["moe"]["router"]["kernel"] * 30
    return {"clip": up, "classifier": params["classifier"]}


@pytest.fixture(scope="module")
def moe_params():
    """The twins' dense params, upcycled."""
    from torch_trainer_twins import np_params

    return upcycled(np_params(), cfgs()[0])


def test_first_step_matches_the_jax_trainer(moe_params):
    jcfg, tcfg = cfgs("auto")
    jt = JTrainer(jcfg, jax.tree.map(jnp.asarray, moe_params["clip"]), JTrainConfig(**STEP, moe=MOE_J),
                  classifier_params=jax.tree.map(jnp.asarray, moe_params["classifier"]), cls_cfg=JCLS, **QUIET)
    tt = Trainer(tcfg, moe_params["clip"], TrainConfig(**STEP, moe=MOE_T),
                 classifier_params=moe_params["classifier"], cls_cfg=TCLS, device="cpu", **QUIET)
    batch = tiny_batch(np.random.default_rng(1))
    before = to_np(moe_params)
    jstate, jmet = jt.train_step(jt.state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    tstate, tmet = tt.train_step(tt.state, batch, tt.generator)
    for k in ("total_loss", "moe_aux", "contrastive_loss", "grad_norm"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-5, err_msg=k)
    assert float(tmet["moe_aux"]) > 1.0
    expected = float(tmet["contrastive_loss"]) + 0.2 * float(tmet["classification_loss"]) \
        + MOE_T.aux_weight * float(tmet["moe_aux"])
    np.testing.assert_allclose(float(tmet["total_loss"]), expected, rtol=1e-6)
    n = assert_close_rel(updates(to_np(tstate.params), before), updates(to_np(jstate.params), before),
                         what="first step")
    assert n > 40 and any("moe" in k for k in before)


def test_data_expert_mesh_equals_one_device(moe_params, monkeypatch):
    """(data 2, expert 4) slots: each expert-stacked leaf, its moments and
    its EMA split over the expert axis, the tokens sent to the slots of
    their experts and back; the gradients, the loss and the first update
    equal the one-device step's."""
    tcfg = cfgs("auto")[1]
    kw = dict(STEP, moe=MOE_T, ema_decay=0.9)
    one = Trainer(tcfg, moe_params["clip"], TrainConfig(**kw), classifier_params=moe_params["classifier"],
                  cls_cfg=TCLS, device="cpu", **QUIET)
    mesh = get_mesh(8, ("data", "expert"), (2, 4), device="cpu")
    many = Trainer(tcfg, moe_params["clip"], TrainConfig(**kw), classifier_params=moe_params["classifier"],
                   cls_cfg=TCLS, mesh=mesh, **QUIET)
    fc = many.state.params["clip"]["visual"]["blocks"][1]["moe"]["fc"]["kernel"]
    assert isinstance(fc, ShardedTensor) and fc.sharding.spec == ("expert", None, None)
    assert [tuple(s.shape) for s in fc.shards] == [(1, 64, 256)] * 8
    assert fc.sharding.shard_index(5) == 1
    router = many.state.params["clip"]["visual"]["blocks"][1]["moe"]["router"]["kernel"]
    assert router.sharding.dim is None
    mu = many.state.opt_state["mu"]["clip/visual/blocks/1/moe/proj/kernel"]
    assert mu.sharding.spec == ("expert", None, None) and mu.shards[0].shape[0] == 1
    placed = ep.shard_moe_params(mesh, moe_params["clip"])  # the serving layout: the same rule
    bias = placed["text"]["blocks"][1]["moe"]["fc"]["bias"]
    assert bias.sharding.spec == ("expert", None) and bias.shards[3].shape == (1, 256)
    np.testing.assert_array_equal(bias.full().numpy(), moe_params["clip"]["text"]["blocks"][1]["moe"]["fc"]["bias"])

    captured, exchanges = {}, []
    one.optimizer.apply = lambda params, grads, state, **kw_: captured.setdefault("one", grads) is None
    real_apply, real_exchange = tf._fsdp_apply, ep.ExpertShards.exchange

    def fsdp_apply(optimizer, state, grads, mesh_):
        captured["mesh"] = grads
        return real_apply(optimizer, state, grads, mesh_)

    def exchange(xin, p, fn):
        exchanges.append(len(p["fc"]["kernel"].shards))
        return real_exchange(xin, p, fn)

    monkeypatch.setattr(tf, "_fsdp_apply", fsdp_apply)
    monkeypatch.setattr(ep.ExpertShards, "exchange", staticmethod(exchange))
    batch = tiny_batch(np.random.default_rng(2))
    _, m1 = one.train_step(one.state, batch, one.generator)
    before = to_np({"clip": moe_params["clip"]})
    state, m8 = many.train_step(many.state, batch, many.generator)
    assert exchanges == [4, 4, 4, 4]  # 2 data slots x (vision + text) MoE layers, 4 expert slots each
    for k in ("total_loss", "moe_aux", "contrastive_loss"):
        np.testing.assert_allclose(float(m8[k]), float(m1[k]), rtol=1e-6, err_msg=k)
    g1, g8 = to_np(captured["one"]), to_np(captured["mesh"])
    assert g1.keys() == g8.keys()
    assert assert_close_rel(g8, g1, tol=1e-5, what="mesh gradients") > 40
    whole = to_np(many._whole(state.params))
    for k, v in whole.items():  # the mesh's first update, from the same gradients
        if k.startswith("clip/") and "moe" in k:
            assert np.abs(v - before[k]).max() > 0, k
    ema = state.ema_params["clip"]["text"]["blocks"][1]["moe"]["fc"]["kernel"]
    assert isinstance(ema, ShardedTensor) and ema.sharding.spec == ("expert", None, None)
    np.testing.assert_allclose(ema.full().numpy(), 0.9 * before["clip/text/blocks/1/moe/fc/kernel"]
                               + 0.1 * whole["clip/text/blocks/1/moe/fc/kernel"], rtol=0, atol=1e-6)


@pytest.mark.parametrize("per_slot, context, group", [(16, 77, 256), (3, 16, 36)])
def test_token_groups_across_slots_match_one_device_and_jax(per_slot, context, group, monkeypatch):
    """Token groups of the one-device step that cross the slots' row
    boundary: 16 rows of 77 tokens a slot at the CLI's group size (S 224 of
    2,464 text tokens, 5.5 groups a slot), and 3 rows a slot at group size
    36 (S 34 of 102 image tokens, S 32 of 96 text tokens). The (data 2,
    expert 2) step's loss, aux and gradients against one device (1e-5)
    and against the JAX step (5e-3)."""
    from evr_tpu_torch.models.classifier import init_classifier_params
    from evr_tpu_torch.models.clip import init_clip_params

    jcfg, tcfg = cfgs("auto")
    jcfg = dataclasses.replace(jcfg, text=dataclasses.replace(jcfg.text, context_length=context))
    tcfg = dataclasses.replace(tcfg, text=dataclasses.replace(tcfg.text, context_length=context))
    params = upcycled({"clip": init_clip_params(0, tcfg), "classifier": init_classifier_params(1, TCLS)}, jcfg)
    n = 2 * per_slot
    batch = tiny_batch(np.random.default_rng(4), n)
    batch["tokens"] = np.pad(batch["tokens"], ((0, 0), (0, context - batch["tokens"].shape[1])))
    crossing = [T for T in (17, context) if (per_slot * T) % tm.moe_group(n * T, group)]
    assert crossing == ([context] if context == 77 else [17, context])
    kw = dict(STEP, batch_size=n, moe=dataclasses.replace(MOE_T, group_size=group))
    jmet, jg = jax_gradients(dict(kw, moe=dataclasses.replace(MOE_J, group_size=group)), params, batch, jcfg=jcfg)
    tmet, tg = port_gradients(kw, params, batch, tcfg=tcfg)
    captured = {}
    monkeypatch.setattr(tf, "_fsdp_apply", lambda opt, state, g, mesh: captured.setdefault("mesh", g) is None)
    many = Trainer(tcfg, params["clip"], TrainConfig(**kw), classifier_params=params["classifier"], cls_cfg=TCLS,
                   device="cpu", mesh=get_mesh(4, ("data", "expert"), (2, 2), device="cpu"), **QUIET)
    _, mmet = many.train_step(many.state, batch, many.generator)
    for k in ("total_loss", "moe_aux", "contrastive_loss"):
        np.testing.assert_allclose(float(mmet[k]), tmet[k], rtol=1e-6, err_msg=k)
        np.testing.assert_allclose(tmet[k], jmet[k], rtol=1e-5, err_msg=k)
    mesh_g = to_np(captured["mesh"])
    assert assert_close_rel(mesh_g, tg, tol=1e-5, what="mesh against one device") > 40
    assert assert_close_rel(mesh_g, jg, what="mesh against JAX") > 40


def test_patch_drop_with_moe_matches_jax(moe_params, monkeypatch):
    """FLIP patch drop through the MoE vision tower, with the JAX step's
    keep indices handed to the port."""
    def draw(generator, batch, n_patches, n_keep, device):
        _, drop = jax.random.split(jax.random.PRNGKey(0))
        u = jax.random.uniform(drop, (batch, n_patches))
        return torch.from_numpy(np.array(jnp.argsort(u, axis=-1)[:, :n_keep])).to(device)

    monkeypatch.setattr(tf, "draw_patch_keep", draw)
    batch = tiny_batch(np.random.default_rng(3))
    jm_, jg = jax_gradients(dict(STEP, moe=MOE_J, patch_drop=0.5), moe_params, batch)
    tm_, tg = port_gradients(dict(STEP, moe=MOE_T, patch_drop=0.5), moe_params, batch, torch.Generator())
    for k in ("total_loss", "moe_aux"):
        np.testing.assert_allclose(tm_[k], jm_[k], rtol=1e-5, err_msg=k)
    assert assert_close_rel(tg, jg, what="patch drop + moe") > 40


def test_refusals_match_the_jax_trainer(moe_params):
    """LoRA with MoE and FSDP over an expert axis raise in both packages;
    GradCache with MoE raises in the port's ``make_grad_fn`` as in JAX's."""
    jcfg, tcfg = cfgs("auto")
    with pytest.raises(ValueError, match="lora_rank > 0 with cfg.moe"):
        JTrainer(jcfg, jax.tree.map(jnp.asarray, moe_params["clip"]), JTrainConfig(moe=MOE_J, lora_rank=4), **QUIET)
    with pytest.raises(ValueError, match="lora_rank > 0 with cfg.moe"):
        Trainer(tcfg, moe_params["clip"], TrainConfig(moe=MOE_T, lora_rank=4), device="cpu", **QUIET)
    with pytest.raises(ValueError, match="fsdp=True with an 'expert' mesh axis"):
        Trainer(tcfg, moe_params["clip"], TrainConfig(moe=MOE_T), fsdp=True,
                mesh=get_mesh(4, ("data", "expert"), (2, 2), device="cpu"), **QUIET)
    with pytest.raises(ValueError, match="gradcache_chunks > 1 is unsupported with moe"):
        tf.make_grad_fn(tcfg, TCLS, TrainConfig(moe=MOE_T, gradcache_chunks=2))


def test_cli_moe_and_expert_parallel_flags(tmp_path, monkeypatch, capsys):
    """``--moe-experts 4 --expert-parallel 2`` over 4 CPU slots: a (data 2,
    expert 2) mesh, upcycled towers, ``moe_aux`` in the history, the
    MoEConfig in the checkpoint; the JAX CLI's refusals."""
    from evr_tpu_torch.tools import finetune as cli
    from test_torch_finetune import _caption_set

    monkeypatch.setenv("EVR_TPU_CPU_DEVICES", "4")
    js = _caption_set(tmp_path, 10)
    save = tmp_path / "ckpt"
    base = ["--train-json", str(js), "--data-dir", str(tmp_path), "--model", "ViT-Tiny-Test", "--device", "cpu",
            "--batch-size", "4", "--epochs", "1", "--save-dir", str(save)]
    result = cli.main(base + ["--moe-experts", "4", "--moe-router-k", "1", "--moe-every", "1",
                              "--moe-capacity", "2.0", "--moe-aux-weight", "0.05", "--expert-parallel", "2"])
    out = capsys.readouterr().out
    assert "mesh {'data': 2, 'expert': 2}" in out and "sparse-upcycled dense init to 4 experts (top-1)" in out
    assert np.isfinite(result["history"][0]["train_moe_aux"])
    payload = torch.load(save / "final_checkpoint.pt", weights_only=True)
    assert payload["moe"] == dataclasses.asdict(tm.MoEConfig(4, 1, 2.0, 1, 0.05))
    assert payload["params"]["clip"]["visual"]["blocks"][0]["moe"]["fc"]["kernel"].shape == (4, 64, 256)
    assert load_torch_checkpoint(save / "final_checkpoint.pt")["moe"] == tm.MoEConfig(4, 1, 2.0, 1, 0.05)
    for flags, match in ((["--expert-parallel", "2"], "requires --moe-experts"),
                         (["--moe-experts", "3", "--expert-parallel", "2"], "must divide"),
                         (["--moe-experts", "3", "--expert-parallel", "3"], "don't divide")):
        with pytest.raises(SystemExit, match=match):
            cli.main(base + flags)


def test_checkpoint_serves_like_the_jax_engine(moe_params, tmp_path):
    """A trainer file with ``payload["moe"]``: ``from_checkpoint`` builds the
    MoE engine, whose frames and texts equal the JAX engine's on the same
    params (1e-5); a dense engine refuses the file, int8 with MoE raises."""
    tcfg = cfgs("auto")[1]
    tt = Trainer(tcfg, moe_params["clip"], TrainConfig(**STEP, moe=MOE_T, save_dir=str(tmp_path)),
                 device="cpu", **QUIET)
    tt.save_checkpoint("final_checkpoint", 0, {})
    path = tmp_path / "final_checkpoint.pt"
    engine = EmbeddingEngine.from_checkpoint(path, cfg=tcfg, device="cpu", batch_size=4)
    assert engine.moe == MOE_T and engine.active_model == "finetuned"
    jengine = JEngine(cfg=cfgs()[0], params=jax.tree.map(jnp.asarray, moe_params["clip"]), moe=MOE_J, batch_size=4)
    rng = np.random.default_rng(4)
    staged = (rng.random((6, 32, 32, 3)) * 255).astype(np.uint8)
    np.testing.assert_allclose(engine.encode_staged_images(staged), jengine.encode_staged_images(staged),
                               rtol=0, atol=1e-5)
    ids = tiny_batch(rng, 3)["tokens"]  # the tiny geometry's 16-token context and 600 ids
    engine.tokenizer = jengine.tokenizer = lambda texts, context_length: ids[: len(texts)]
    got, ref = engine.encode_texts(["a", "b", "c"]), jengine.encode_texts(["a", "b", "c"])
    assert got.shape == (3, 32)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    dense = EmbeddingEngine(cfg=tcfg, device="cpu", batch_size=4)
    with pytest.raises(ValueError, match="MoE checkpoint"):
        dense.load_finetuned(path)
    with pytest.raises(NotImplementedError, match="int8"):
        EmbeddingEngine.from_checkpoint(path, cfg=tcfg, device="cpu", params_dtype="int8")


def test_serving_cli_builds_the_engine_of_its_checkpoint(tmp_path):
    """``serving.__main__.build_engine`` with ``--checkpoint``: an MoE
    trainer file builds the MoE engine on its ``MoEConfig`` and serves the
    file as "finetuned" beside "original" (rows equal to
    ``from_checkpoint``'s); a dense file keeps the dense engine."""
    from evr_tpu_torch.models import get_model_config
    from evr_tpu_torch.models.clip import init_clip_params
    from evr_tpu_torch.serving.__main__ import build_engine, parse_args

    cfg = get_model_config("ViT-Tiny-Test")
    moe = tm.MoEConfig(n_experts=4, router_k=2, moe_every=1, group_size=64)
    files = {"moe": tmp_path / "moe.pt", "dense": tmp_path / "dense.pt"}
    torch.save({"params": {"clip": tm.init_moe_clip_params(3, cfg, moe)}, "opt_state": {}, "step": 0,
                "moe": dataclasses.asdict(moe)}, files["moe"])
    torch.save({"params": {"clip": init_clip_params(3, cfg)}, "opt_state": {}, "step": 0}, files["dense"])
    staged = (np.random.default_rng(5).random((3, 64, 64, 3)) * 255).astype(np.uint8)
    for kind, path in files.items():
        served = build_engine(parse_args(["--data-root", str(tmp_path / "root"), "--model", "ViT-Tiny-Test",
                                          "--device", "cpu", "--checkpoint", str(path), "--batch-size", "4",
                                          "--local-ocr", "off"]))
        assert served.moe == (moe if kind == "moe" else None)
        assert served.active_model == "original" and "finetuned" in served.models
        ref = EmbeddingEngine.from_checkpoint(path, "ViT-Tiny-Test", device="cpu", batch_size=4)
        served.set_active_model("finetuned")
        np.testing.assert_array_equal(served.encode_staged_images(staged), ref.encode_staged_images(staged))
        if kind == "moe":  # the file's towers serve as "original" too
            served.set_active_model("original")
            np.testing.assert_array_equal(served.encode_staged_images(staged), ref.encode_staged_images(staged))
