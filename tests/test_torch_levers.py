"""The trainer's other levers against ``evr_tpu`` on the CPU: gradient
accumulation (optax ``MultiSteps``), remat, their composition with the EMA,
warmup, bf16 moments and patch drop through a checkpoint, the projection
trainer's two levers, and ``Trainer.evaluate_retrieval``.

Seeded numpy params and batches handed to both packages, fp32, classifier
dropout 0 (``tests/torch_trainer_twins.py``). Tolerances: updates and
gradients 5e-3 relative L2; the accumulation calls that do not emit leave
every param bit-equal in both packages; remat is bit-equal to no remat in
the port (the same products in the same order, recomputed).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from evr_tpu.training import Trainer as JTrainer
from evr_tpu.training import TrainConfig as JTrainConfig
from evr_tpu.training import variants as jv
from evr_tpu_torch.models import clip as tclip
from evr_tpu_torch.models.convert import params_from_numpy
from evr_tpu_torch.training import Trainer, TrainConfig, make_grad_fn
from evr_tpu_torch.training import variants as tv
from evr_tpu_torch.training.finetune import flat_leaves

from torch_trainer_twins import (
    JCLS, TCLS, _capture, assert_close_rel, cfgs, jax_gradients, jax_steps, np_params, port_gradients, port_steps,
    tiny_batch, to_np, updates, without_key_bias,
)
from torch_threads import one_torch_thread  # noqa: F401

STEP = dict(lr=1e-3, batch_size=8, epochs=2, compute_dtype="float32", freeze_layers=8)


@pytest.fixture(scope="module")
def accumulation():
    kw = dict(STEP, grad_accumulation_steps=2, ema_decay=0.9)
    params = np_params()
    rng = np.random.default_rng(0)
    batches = [tiny_batch(rng) for _ in range(4)]
    return params, batches, jax_steps(kw, params, batches), port_steps(kw, params, batches)


def test_accumulation_matches_jax_over_four_calls(accumulation):
    params, batches, (jm, jafter, jstate), (tm, tafter, tstate) = accumulation
    before = to_np(params)
    for s in range(4):
        np.testing.assert_allclose(tm[s]["total_loss"], jm[s]["total_loss"], rtol=1e-5)
        np.testing.assert_allclose(tm[s]["grad_norm"], jm[s]["grad_norm"], rtol=1e-4)
        prev_t, prev_j = (before, before) if s == 0 else (tafter[s - 1], jafter[s - 1])
        if s % 2 == 0:  # calls 1 and 3 accumulate only
            for k in prev_t:
                np.testing.assert_array_equal(tafter[s][k], prev_t[k], err_msg=f"call {s + 1}: {k}")
                np.testing.assert_array_equal(jafter[s][k], prev_j[k], err_msg=f"jax call {s + 1}: {k}")
        else:
            assert assert_close_rel(updates(tafter[s], prev_t), updates(jafter[s], prev_j), what=f"call {s + 1}") >= 40
    state = tstate.opt_state
    assert state["mini_step"] == int(jstate.opt_state.mini_step) == 0
    assert state["gradient_step"] == int(jstate.opt_state.gradient_step) == 2
    assert state["inner_opt_state"]["count"] == 2 and tstate.step == int(jstate.step) == 4
    assert all(not v.any() for v in state["acc_grads"].values())
    # the trainable leaves' EMA (a frozen leaf's EMA moves by a last bit in
    # XLA's fused d·e + (1 − d)·p, not in the port's)
    assert_close_rel(updates(to_np(tstate.ema_params), before), updates(to_np(jstate.ema_params), before),
                     what="ema", keys=list(state["inner_opt_state"]["mu"])) >= 40


def test_accumulated_mean_is_welford_of_the_calls_gradients(accumulation):
    """The update of call 2 is the inner optimizer applied to
    ``g1 + (g2 − g1) / 2``: held against the port's own gradients of the two
    calls, the mini step and the accumulator after call 1 against JAX's."""
    params, batches, _, _ = accumulation
    kw = dict(STEP, grad_accumulation_steps=2)
    from evr_tpu_torch.training import TrainState, make_optimizer, make_train_step

    tp = params_from_numpy(params)
    opt = make_optimizer(TrainConfig(**kw), tp)
    step, _ = make_train_step(cfgs()[1], TCLS, TrainConfig(**kw), opt)
    state = TrainState(params=tp, opt_state=opt.init(tp), step=0)
    _, g1 = port_gradients(kw, params, batches[0])
    step(state, batches[0])
    acc = to_np(state.opt_state["acc_grads"])
    assert all(np.array_equal(acc[k], g1[k]) for k in g1) and state.opt_state["mini_step"] == 1
    _, g2 = port_gradients(kw, params, batches[1])
    mean = {k: (torch.from_numpy(g1[k]) + (torch.from_numpy(g2[k]) - torch.from_numpy(g1[k])) / 2).numpy()
            for k in g1}
    _, jg1 = jax_gradients(kw, params, batches[0])
    assert_close_rel(acc, jg1, what="accumulator after call 1")
    inner = make_optimizer(TrainConfig(**STEP), params_from_numpy(params))
    ref = params_from_numpy(params)
    inner.apply(ref, {k: torch.from_numpy(v) for k, v in mean.items()}, inner.init(ref))
    step(state, batches[1])
    got, want = to_np(state.params), to_np(ref)
    assert all(np.array_equal(got[k], want[k]) for k in want)


@pytest.mark.parametrize("impl", ["plain", "xla"])
def test_remat_is_bit_equal_to_no_remat_and_matches_jax(impl):
    params = np_params()
    batch = tiny_batch(np.random.default_rng(1))
    _, tcfg = cfgs(impl)
    m0, g0 = port_gradients(STEP, params, batch, tcfg=tcfg)
    m1, g1 = port_gradients(dict(STEP, remat=True), params, batch, tcfg=dataclasses.replace(tcfg, remat=True))
    assert m0 == m1 and all(np.array_equal(g0[k], g1[k]) for k in g0)
    jcfg = dataclasses.replace(cfgs()[0], remat=True)
    _, jg = jax_gradients(dict(STEP, remat=True), params, batch, jcfg=jcfg)
    assert assert_close_rel(g1, jg, what="remat") >= 40


def test_remat_trainer_switch_and_the_fast_final_blocks():
    _, tcfg = cfgs()
    params = np_params()
    tr = Trainer(tcfg, params["clip"], TrainConfig(remat=True, compute_dtype="float32"), device="cpu",
                 log_fn=lambda *_: None)
    assert tr.model_cfg.remat and not tcfg.remat
    clip = params_from_numpy(params["clip"])
    staged = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (2, 32, 32, 3), dtype=np.uint8))
    rcfg = dataclasses.replace(tcfg, remat=True)
    # the pooled-row final block stays off under remat: the full last block runs
    full = tclip.encode_staged_u8(clip, tcfg, staged, cls_fast_final=False)
    assert torch.equal(tclip.encode_staged_u8(clip, rcfg, staged, cls_fast_final=True), full)
    tokens = torch.from_numpy(tiny_batch(np.random.default_rng(3), 2)["tokens"])
    assert torch.equal(tclip.encode_text(clip, rcfg, tokens, eot_fast_final=True),
                       tclip.encode_text(clip, tcfg, tokens))


def test_options_compose_save_and_restore(tmp_path):
    """Remat + EMA + warmup + bf16 moments + patch drop + accumulation in
    one Trainer: the steps optimise the full-sequence eval loss; a
    checkpoint saved mid-accumulation (after an odd call) restores the
    accumulator, and the next calls of the restored Trainer equal the
    original's bit for bit."""
    _, tcfg = cfgs()
    params = np_params()
    tc = TrainConfig(freeze_layers=0, lr=1e-3, batch_size=8, epochs=1, compute_dtype="float32", remat=True,
                     ema_decay=0.9, warmup_steps=1, adam_mu_dtype="bfloat16", patch_drop=0.25,
                     grad_accumulation_steps=2, save_dir=str(tmp_path / "ckpt"))

    def trainer():
        return Trainer(tcfg, params["clip"], tc, classifier_params=params["classifier"], cls_cfg=TCLS,
                       device="cpu", log_fn=lambda *_: None)

    tr = trainer()
    batch = tiny_batch(np.random.default_rng(4))
    before = tr.eval_step(tr.state, batch)["total_loss"].item()
    for _ in range(7):
        tr.state, m = tr.train_step(tr.state, batch, tr.generator)
        assert np.isfinite(m["total_loss"].item())
    assert tr.eval_step(tr.state, batch)["total_loss"].item() < before
    assert tr.state.opt_state["mini_step"] == 1 and tr.state.opt_state["gradient_step"] == 3
    tr.save_checkpoint("combo", epoch=0, metrics={})
    tr2 = trainer()
    tr2.restore_checkpoint("combo")
    tr2.generator.set_state(tr.generator.get_state())
    a, b = tr2.state.opt_state, tr.state.opt_state
    assert (a["mini_step"], a["gradient_step"]) == (1, 3)
    assert all(torch.equal(a["acc_grads"][k], b["acc_grads"][k]) for k in b["acc_grads"])
    assert a["inner_opt_state"]["mu"]["clip/visual/proj"].dtype == torch.bfloat16
    for _ in range(2):
        tr.state, _ = tr.train_step(tr.state, batch, tr.generator)
        tr2.state, _ = tr2.train_step(tr2.state, batch, tr2.generator)
    for k, v in to_np(tr.state.params).items():
        np.testing.assert_array_equal(to_np(tr2.state.params)[k], v, err_msg=k)
    assert all(np.array_equal(x, y) for x, y in zip(to_np(tr.state.ema_params).values(),
                                                    to_np(tr2.state.ema_params).values()))


def _projection_pair(kw, seed):
    jcfg, tcfg = cfgs("xla")
    np_params_ = np_params(seed, classifier=False)["clip"]
    cfg = dict(proj_dim=16, lr=1e-3, compute_dtype="float32", num_classes=3, **kw)
    jtr = jv.ProjectionTrainer(jcfg, jax.tree.map(jnp.asarray, np_params_), jv.ProjectionTrainConfig(**cfg))
    ttr = tv.ProjectionTrainer(tcfg, np_params_, tv.ProjectionTrainConfig(**cfg), device="cpu")
    ttr.params["heads"] = params_from_numpy(jax.tree.map(np.asarray, jtr.params["heads"]))
    return jtr, ttr


def _jax_projection_gradients(jtr, batch) -> dict:
    """The JAX projection trainer's gradients of ``batch``, read through a
    capturing optimizer swapped in for one step (its state restored; the
    capturing step is built, and compiled, once a trainer)."""
    saved = jtr.optimizer, jtr.opt_state, jtr._step, jtr.params
    jtr.optimizer = _capture()
    if not hasattr(jtr, "_capturing"):
        jtr._capturing = jtr._build_step()
    jtr._step = jtr._capturing
    jtr.opt_state = jtr.optimizer.init(jtr._trainable(jtr.params))
    jtr.train_step(batch)
    grads = to_np(jtr.opt_state)
    jtr.optimizer, jtr.opt_state, jtr._step, jtr.params = saved
    return grads


@pytest.mark.parametrize("kw, calls", [(dict(freeze_clip=False), 2), (dict(grad_accumulation_steps=2), 4),
                                       (dict(freeze_clip=False, grad_accumulation_steps=2), 2)])
def test_projection_trainer_levers_match_jax(kw, calls):
    """Each call's gradients at 5e-3; the calls that do not emit leave the
    params bit-equal in both; the heads' updates at 5e-3. The towers'
    first Adam updates are near sign vectors (each element divided by its
    own root mean square), so an element whose gradient sits at rounding
    level moves by a full step either way: the towers' leaves are held by
    update cosine (0.999), their gradients at 5e-3."""
    jtr, ttr = _projection_pair(kw, 2)
    assert ttr.model_cfg.remat == (not ttr.cfg.freeze_clip) and not ttr._infer_cfg.remat
    rng = np.random.default_rng(7)
    batches = [tiny_batch(rng) for _ in range(calls)]
    k = ttr.cfg.grad_accumulation_steps
    for s, b in enumerate(batches):
        before_t, before_j = to_np(ttr.params), to_np(jtr.params)
        _, tg = ttr.gradients(b)
        assert assert_close_rel(to_np(tg), _jax_projection_gradients(jtr, b), what=f"call {s + 1} gradients") > 0
        jm, tm = jtr.train_step(b), ttr.train_step(b)
        np.testing.assert_allclose(tm["total_loss"], jm["total_loss"], rtol=1e-5)
        after_t, after_j = to_np(ttr.params), to_np(jtr.params)
        if (s + 1) % k:
            assert all(np.array_equal(after_t[x], before_t[x]) for x in before_t)
            assert all(np.array_equal(after_j[x], before_j[x]) for x in before_j)
            continue
        ut, uj = updates(after_t, before_t), updates(after_j, before_j)
        heads = [x for x in ut if x.startswith("heads/")]
        assert assert_close_rel(ut, uj, what=f"call {s + 1}", keys=heads) == len(heads)
        towers = [x for x in ut if x.startswith("clip/")]
        for x in towers:
            if ttr.cfg.freeze_clip:
                assert not ut[x].any() and not uj[x].any()
                continue
            a, b = without_key_bias(x, ut[x]), without_key_bias(x, uj[x])
            cos = float((a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b)))
            assert cos >= 0.999, (x, cos)
    img_t, _ = ttr.encode_projected(batches[0]["images"], batches[0]["tokens"])
    img_j, _ = jtr.encode_projected(batches[0]["images"], batches[0]["tokens"])
    # the trained towers apart by the few rounding-level Adam elements above
    np.testing.assert_allclose(img_t, img_j, atol=1e-5 if ttr.cfg.freeze_clip else 1e-4)


def test_evaluate_retrieval_matches_jax():
    jcfg, tcfg = cfgs()
    params = np_params()
    kw = dict(compute_dtype="float32", freeze_layers=0)
    jt = JTrainer(jcfg, jax.tree.map(jnp.asarray, params["clip"]), JTrainConfig(**kw), log_fn=lambda *_: None)
    tt = Trainer(tcfg, params["clip"], TrainConfig(**kw), device="cpu", log_fn=lambda *_: None)
    rng = np.random.default_rng(8)
    batches = [tiny_batch(rng) for _ in range(3)]
    jr, tr = jt.evaluate_retrieval(batches), tt.evaluate_retrieval(batches)
    assert tr["t2i_ranks"] == jr["t2i_ranks"] and tr["i2t_ranks"] == jr["i2t_ranks"]
    for direction in ("t2i", "i2t", "mean"):
        for k, v in jr[direction].items():
            np.testing.assert_allclose(tr[direction][k], v, rtol=1e-6, err_msg=f"{direction} {k}")


def test_moe_is_the_one_lever_left_unported():
    """No lever is left unported: an MoE config passes ``check_supported``
    and builds the step beside the other levers."""
    from evr_tpu_torch.models.moe import MoEConfig
    from evr_tpu_torch.training.finetune import check_supported

    check_supported(TrainConfig(moe=MoEConfig()))
    make_grad_fn(cfgs()[1], TCLS, TrainConfig(moe=MoEConfig(n_experts=4), remat=True, patch_drop=0.5,
                                              grad_accumulation_steps=4))
    _, tcfg = cfgs()
    # the mesh, refused until it was ported, now builds the trainer over its slots
    from evr_tpu_torch.parallel import get_mesh

    assert tv.ProjectionTrainer(tcfg, np_params()["clip"], mesh=get_mesh(2, device="cpu")).mesh.size == 2
    make_grad_fn(tcfg, TCLS, TrainConfig(lora_rank=4, optimizer="muon", remat=True, patch_drop=0.5,
                                         grad_accumulation_steps=4))
