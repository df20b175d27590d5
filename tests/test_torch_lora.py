"""The port's LoRA (``training.lora``, the Trainer's ``lora_rank``) against
``evr_tpu.training.lora`` on the CPU.

JAX's adapters (``init_lora`` under a PRNG key) are carried across with
``params_from_numpy``; the train steps run in fp32 with classifier dropout 0
(``tests/torch_trainer_twins.py``). Tolerances: merged kernels 1e-6
relative; gradients and updates 5e-3 relative L2. With ``b = 0`` the first
step's ``a`` gradients are exactly 0 in both packages, so ``b`` is held at
the initial point and both factors at a point one step later.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from evr_tpu.index.engine import load_orbax_checkpoint
from evr_tpu.training import Trainer as JTrainer
from evr_tpu.training import TrainConfig as JTrainConfig
from evr_tpu.training.lora import init_lora as j_init_lora
from evr_tpu.training.lora import merge_lora as j_merge_lora
from evr_tpu.training.partition import param_group_labels as j_labels
from evr_tpu_torch.index.engine import EmbeddingEngine, load_torch_checkpoint
from evr_tpu_torch.models.clip import encode_image
from evr_tpu_torch.models.convert import params_from_numpy
from evr_tpu_torch.training import (
    Trainer, TrainConfig, count_labels, init_lora, lora_param_fraction, make_optimizer, merge_lora,
    param_group_labels,
)
from evr_tpu_torch.training.finetune import flat_leaves

from torch_trainer_twins import (
    JCLS, TCLS, assert_close_rel, cfgs, from_flat, jax_gradients, jax_steps, np_params, port_gradients, port_steps,
    tiny_batch, to_np, updates,
)

STEP = dict(lora_rank=4, lr=1e-3, batch_size=8, epochs=2, compute_dtype="float32", freeze_layers=8)


def _with_jax_lora(params, rank=4, key=7, targets=None):
    kw = {} if targets is None else {"targets": targets}
    lora = j_init_lora(jax.random.PRNGKey(key), jax.tree.map(jnp.asarray, params["clip"]), rank, **kw)
    return {**params, "lora": jax.tree.map(np.asarray, lora)}


def test_init_shapes_zero_b_and_identity_merge():
    params = np_params()
    tl = init_lora(torch.Generator().manual_seed(3), params["clip"], 4)
    jl = j_init_lora(jax.random.PRNGKey(3), jax.tree.map(jnp.asarray, params["clip"]), 4)
    t, j = to_np(tl), to_np(jl)
    assert set(t) == set(j) and all(t[k].shape == j[k].shape and t[k].dtype == np.float32 for k in t)
    assert all(not t[k].any() for k in t if k.endswith("/b"))
    a = np.concatenate([t[k].ravel() for k in t if k.endswith("/a")])
    assert abs(a.std() - 0.5) < 0.02  # N(0, 1/r), r 4
    clip = params_from_numpy(params["clip"])
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 32, 32, 3)).astype(np.float32))
    cfg = cfgs()[1]
    assert torch.equal(encode_image(clip, cfg, x), encode_image(merge_lora(clip, tl, 16.0), cfg, x))
    assert 0 < lora_param_fraction(params["clip"], tl) < 0.25
    with pytest.raises(ValueError, match="rank"):
        init_lora(0, params["clip"], 0)


def test_merge_matches_jax():
    params = _with_jax_lora(np_params())
    rng = np.random.default_rng(1)
    for blk in params["lora"]["visual"]["blocks"] + params["lora"]["text"]["blocks"]:
        for lin in (blk["attn"]["qkv"], blk["mlp"]["proj"]):
            lin["b"] = rng.standard_normal(lin["b"].shape).astype(np.float32)
    jm = to_np(j_merge_lora(jax.tree.map(jnp.asarray, params["clip"]),
                            jax.tree.map(jnp.asarray, params["lora"]), 8.0))
    tp = params_from_numpy(params)
    tm = merge_lora(tp["clip"], tp["lora"], 8.0)
    got = to_np(tm)
    assert set(got) == set(jm)
    for k in jm:
        np.testing.assert_allclose(got[k], jm[k], rtol=1e-6, atol=1e-7, err_msg=k)
    assert tm["visual"]["pos_embedding"] is tp["clip"]["visual"]["pos_embedding"]  # shared, not copied
    assert tm["visual"]["blocks"][0]["ln_1"] is tp["clip"]["visual"]["blocks"][0]["ln_1"]


@pytest.mark.parametrize("targets", [("attn.qkv",), None])
def test_labels_freeze_the_base_as_jax(targets):
    params = _with_jax_lora(np_params(), targets=targets)
    got = param_group_labels(params_from_numpy(params), 8)
    assert got == j_labels(params, 8)
    counts = count_labels(got)
    n_clip = len(flat_leaves(params["clip"]))
    n_adapters = 2 * 2 * 2 * (1 if targets else 4)  # towers x blocks x (a, b) x targets
    assert counts["frozen"] == n_clip - 1  # logit_scale stays trainable
    assert counts["visual"] + counts["text"] == n_adapters and counts["classifier"] == 4


def test_lora_gradients_match_jax():
    """At the initial point (b = 0) the a gradients are exactly 0 in both
    and b is held; one JAX step later both factors are."""
    params = _with_jax_lora(np_params())
    batch = tiny_batch(np.random.default_rng(2))
    jm, jg = jax_gradients(STEP, params, batch)
    tm, tg = port_gradients(STEP, params, batch)
    np.testing.assert_allclose(tm["total_loss"], jm["total_loss"], rtol=1e-5)
    a_keys = [k for k in tg if k.endswith("/a")]
    assert a_keys and all(not tg[k].any() and not jg[k].any() for k in a_keys)
    assert set(tg) == {k for k in jg if k.startswith(("lora/", "classifier/")) or k == "clip/logit_scale"}
    assert assert_close_rel(tg, jg, what="b at step 1", keys=[k for k in tg if not k.endswith("/a")]) > 8
    _, after, _ = jax_steps(STEP, params, [batch])
    point = from_flat(params, after[0])
    batch2 = tiny_batch(np.random.default_rng(3))
    jm2, jg2 = jax_gradients(STEP, point, batch2)
    tm2, tg2 = port_gradients(STEP, point, batch2)
    np.testing.assert_allclose(tm2["total_loss"], jm2["total_loss"], rtol=1e-5)
    assert assert_close_rel(tg2, jg2, what="a and b at step 2") == len(tg2)


@pytest.fixture(scope="module")
def lora_steps():
    params = _with_jax_lora(np_params())
    rng = np.random.default_rng(4)
    batches = [tiny_batch(rng) for _ in range(3)]
    return params, jax_steps(STEP, params, batches), port_steps(STEP, params, batches)


def test_lora_steps_match_jax_and_keep_the_base_still(lora_steps):
    params, (jm, jafter, _), (tm, tafter, _) = lora_steps
    before = to_np(params)
    for s in range(3):
        np.testing.assert_allclose(tm[s]["total_loss"], jm[s]["total_loss"], rtol=1e-5)
        np.testing.assert_allclose(tm[s]["grad_norm"], jm[s]["grad_norm"], rtol=1e-4)
        prev_t = before if s == 0 else tafter[s - 1]
        prev_j = before if s == 0 else jafter[s - 1]
        moved = assert_close_rel(updates(tafter[s], prev_t), updates(jafter[s], prev_j), what=f"step {s}")
        assert moved == 8 * 2 * 2 + 1 + 4  # every adapter, logit_scale, the classifier
    for k in before:
        if k.startswith("clip/") and k != "clip/logit_scale":
            np.testing.assert_array_equal(tafter[-1][k], before[k], err_msg=k)


def test_optimizer_state_is_adapter_sized():
    params = params_from_numpy(_with_jax_lora(np_params()))
    opt = make_optimizer(TrainConfig(**STEP), params)
    state = opt.init(params)
    keys = {k for k in flat_leaves(params) if k.startswith(("lora/", "classifier/")) or k == "clip/logit_scale"}
    assert set(state["mu"]) == set(state["nu"]) == keys
    moment_bytes = sum(t.numel() * t.element_size() for d in ("mu", "nu") for t in state[d].values())
    base_bytes = sum(t.numel() * t.element_size() for t in flat_leaves(params["clip"]).values())
    assert moment_bytes < base_bytes  # two moments a trainable leaf, the base frozen


def test_trainer_draws_adapters_at_seed_plus_one_and_serves_the_merge(tmp_path):
    _, tcfg = cfgs()
    params = np_params()
    tr = Trainer(tcfg, params["clip"], TrainConfig(**STEP, seed=5), classifier_params=params["classifier"],
                 cls_cfg=TCLS, device="cpu", log_fn=lambda *_: None)
    want = to_np(init_lora(torch.Generator().manual_seed(6), params["clip"], 4))
    got = to_np(tr.state.params["lora"])
    assert all(np.array_equal(got[k], want[k]) for k in want)
    rng = np.random.default_rng(5)
    for i in range(2):
        tr.state, _ = tr.train_step(tr.state, tiny_batch(rng), tr.generator)
    merged = tr.merged_clip_params()
    manual = merge_lora(tr.state.params["clip"], tr.state.params["lora"], 16.0)
    x = torch.from_numpy(rng.standard_normal((3, 32, 32, 3)).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(encode_image(merged, tcfg, x), encode_image(manual, tcfg, x))
        assert (encode_image(merged, tcfg, x) - encode_image(tr.state.params["clip"], tcfg, x)).abs().max() > 0
    assert not any(t.requires_grad for t in flat_leaves(merged).values())


def test_cli_writes_lora_merged_pt_that_serves_and_the_trainer_file_raises(tmp_path):
    from evr_tpu_torch.tools import finetune as cli
    from tests.test_torch_finetune import _caption_set

    js = _caption_set(tmp_path, 10)
    save = tmp_path / "ckpt"
    cli.main(["--train-json", str(js), "--data-dir", str(tmp_path), "--model", "ViT-Tiny-Test",
              "--device", "cpu", "--batch-size", "4", "--epochs", "1", "--save-dir", str(save),
              "--lora-rank", "4", "--lora-alpha", "8"])
    final = torch.load(save / "final_checkpoint.pt", weights_only=True)["params"]
    want = merge_lora(final["clip"], final["lora"], 8.0)
    staged = np.random.default_rng(0).integers(0, 256, (3, 64, 64, 3), dtype=np.uint8)
    engine = EmbeddingEngine.from_checkpoint(save / "lora_merged.pt", "ViT-Tiny-Test", device="cpu", batch_size=4)
    in_memory = EmbeddingEngine("ViT-Tiny-Test", params=want, device="cpu", batch_size=4)
    base = EmbeddingEngine("ViT-Tiny-Test", params=final["clip"], device="cpu", batch_size=4)
    got = engine.encode_staged_images(staged)
    assert np.array_equal(got, in_memory.encode_staged_images(staged))
    assert not np.array_equal(got, base.encode_staged_images(staged))
    with pytest.raises(ValueError, match="LoRA trainer checkpoint.*lora_merged.pt"):
        load_torch_checkpoint(save / "final_checkpoint.pt")


def test_jax_loader_serves_the_untrained_base_of_a_lora_trainer_file(tmp_path):
    """A fault of the reference: ``load_orbax_checkpoint`` returns
    ``params["clip"]`` of a LoRA trainer's checkpoint and ignores
    ``params["lora"]``; the port's loader raises on the same kind of file."""
    jcfg, tcfg = cfgs()
    params = np_params()
    kw = dict(STEP, save_dir=str(tmp_path / "jax"))
    jt = JTrainer(jcfg, jax.tree.map(jnp.asarray, params["clip"]), JTrainConfig(**kw),
                  classifier_params=jax.tree.map(jnp.asarray, params["classifier"]), cls_cfg=JCLS,
                  log_fn=lambda *_: None)
    batch = {k: jnp.asarray(v) for k, v in tiny_batch(np.random.default_rng(6)).items()}
    for i in range(2):
        jt.state, _ = jt.train_step(jt.state, batch, jax.random.PRNGKey(i))
    jt.save_checkpoint("final_checkpoint", 0, {})
    served = to_np(load_orbax_checkpoint(str(tmp_path / "jax" / "final_checkpoint"))["clip"])
    base, merged = to_np(params["clip"]), to_np(jt.merged_clip_params())
    assert all(np.array_equal(served[k], base[k]) for k in base if k != "logit_scale")
    assert any(not np.array_equal(served[k], merged[k]) for k in base)
    tt = Trainer(tcfg, params["clip"], TrainConfig(**kw), classifier_params=params["classifier"], cls_cfg=TCLS,
                 device="cpu", log_fn=lambda *_: None)
    tt.cfg.save_dir = str(tmp_path / "port")
    tt.save_checkpoint("final_checkpoint", 0, {})
    with pytest.raises(ValueError, match="lora_merged.pt"):
        load_torch_checkpoint(tt.checkpoint_path("final_checkpoint"))
