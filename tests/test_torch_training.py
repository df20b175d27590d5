"""The port's fine-tune step against ``evr_tpu.training`` on the CPU.

Same params (``tiny_cfg`` of tests/test_training.py, drawn with numpy from a
seed and handed to both), same numpy batches, classifier dropout 0. The JAX
step runs its towers through the XLA composition (T = 17 < 512); the port
runs them through ``attn_impl="plain"``, the fused kernels' plain forward
and backward (``FusedBlockFunction``). Tolerances: losses and the gradient
norm 1e-5 relative (fp32, sums in another order); each leaf's parameter
update (lr 1e-2, so decay and clipping are visible: decay alone moves a
weight by about 1e-4) 1e-4 in relative L2 norm and 1e-4 per element, since
Adam's normalised update amplifies the last bits of a gradient element where
two steps' gradients nearly cancel; the learning rates, the group labels and
the bf16 moments exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from evr_tpu.models import ClassifierConfig as JClassifierConfig
from evr_tpu.models.clip import CLIPConfig, TextConfig, VisionConfig
from evr_tpu.training import TrainConfig as JTrainConfig
from evr_tpu.training import losses as jlosses
from evr_tpu.training import make_optimizer as j_make_optimizer
from evr_tpu.training import make_train_step as j_make_train_step
from evr_tpu.training.finetune import TrainState as JTrainState
from evr_tpu.training.partition import param_group_labels as j_labels
from evr_tpu_torch.models import clip as tclip
from evr_tpu_torch.models.classifier import ClassifierConfig, init_classifier_params
from evr_tpu_torch.models.convert import params_from_numpy
from evr_tpu_torch.training import (
    TrainConfig,
    TrainState,
    combined_clip_loss,
    count_labels,
    make_optimizer,
    make_train_step,
    param_group_labels,
)
from evr_tpu_torch.training.finetune import flat_leaves


def tiny_cfg(cls=CLIPConfig, vis=VisionConfig, txt=TextConfig, **kw):
    return cls(
        embed_dim=32,
        vision=vis(image_size=32, patch_size=8, width=64, layers=2, heads=4),
        text=txt(context_length=16, vocab_size=600, width=64, layers=2, heads=4),
        **kw,
    )


def tiny_batch(rng, n):
    tokens = np.zeros((n, 16), np.int32)
    for i in range(n):
        ln = int(rng.integers(3, 10))
        tokens[i, :ln] = rng.integers(1, 500, size=ln)
        tokens[i, ln] = 599  # EOT = max id
    return {
        "images": (rng.random((n, 32, 32, 3)) * 255).astype(np.uint8),
        "tokens": tokens,
        "labels": rng.integers(0, 3, size=n).astype(np.int32),
    }


def _np_params():
    """Seeded numpy params, the JAX package's layout, handed to both."""
    clip = tclip.init_clip_params(0, tiny_cfg(tclip.CLIPConfig, tclip.VisionConfig, tclip.TextConfig))
    cls = init_classifier_params(1, ClassifierConfig(embed_dim=32, num_classes=3))
    return {"clip": clip, "classifier": cls}


STEP_CFG = dict(freeze_layers=8, batch_size=8, epochs=2, compute_dtype="float32",
                lr=1e-2, weight_decay=0.1)


def _run_both(**overrides):
    """Two train steps through the JAX package and through the port, from
    the same params and batches: (jax params, jax metrics, jax state,
    port params, port metrics, port state, initial numpy params)."""
    np_params = _np_params()
    rng = np.random.default_rng(5)
    batches = [tiny_batch(rng, 8) for _ in range(2)]

    jcfg = JTrainConfig(**STEP_CFG, **overrides)
    jp = jax.tree.map(jnp.asarray, np_params)
    jopt = j_make_optimizer(jcfg, jp, steps_per_epoch=1)
    jstep, _ = j_make_train_step(tiny_cfg(), JClassifierConfig(embed_dim=32, dropout=0.0), jcfg, jopt)
    jstate = JTrainState(
        params=jax.tree.map(jnp.copy, jp), opt_state=jopt.init(jp), step=jnp.zeros((), jnp.int32),
        ema_params=jax.tree.map(jnp.copy, jp) if jcfg.ema_decay > 0 else None,
    )
    jmetrics = []
    for b in batches:
        jstate, m = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()}, jax.random.PRNGKey(0))
        jmetrics.append({k: float(v) for k, v in m.items()})

    tcfg = TrainConfig(**STEP_CFG, **overrides)
    tp = params_from_numpy(np_params)
    topt = make_optimizer(tcfg, tp, steps_per_epoch=1)
    mcfg = dataclasses.replace(
        tiny_cfg(tclip.CLIPConfig, tclip.VisionConfig, tclip.TextConfig), attn_impl="plain")
    tstep, _ = make_train_step(mcfg, ClassifierConfig(embed_dim=32, dropout=0.0), tcfg, topt)
    tstate = TrainState(
        params=tp, opt_state=topt.init(tp), step=0,
        ema_params=params_from_numpy(np_params) if tcfg.ema_decay > 0 else None,
    )
    tmetrics = []
    for b in batches:
        tstate, m = tstep(tstate, b)
        tmetrics.append({k: float(v) for k, v in m.items()})
    return jstate, jmetrics, tstate, tmetrics, np_params


@pytest.fixture(scope="module")
def two_steps():
    return _run_both(ema_decay=0.9)


def _flat_np(tree):
    return {k: v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in flat_leaves(tree).items()}


def _assert_update_close(got, ref, what):
    """A leaf's update: L2 error ≤ 1e-4 of the update's norm (plus 1e-6, for
    a frozen leaf's EMA that fp32 rounding may move by its last bit) and no
    element off by more than 1e-4 (1 % of the learning rate)."""
    err = np.linalg.norm(got - ref)
    assert err <= 1e-4 * np.linalg.norm(ref) + 1e-6, (what, err, np.linalg.norm(ref))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4, err_msg=what)


def test_group_labels_match_jax():
    np_params = _np_params()
    for freeze in (0, 8, 30):
        got = param_group_labels(params_from_numpy(np_params), freeze)
        assert got == j_labels(np_params, freeze)
    counts = count_labels(param_group_labels(params_from_numpy(np_params), 8))
    assert counts["frozen"] == 16 and counts["classifier"] == 4


def test_learning_rates_match_optax_over_warmup_and_epochs():
    """With b1 = b2 = eps = 0, no decay and no clipping, each optax update
    of a unit gradient is exactly −lr of its group: held to the port's
    learning rates step by step."""
    params = {"clip": {"visual": {"a": np.ones(2, np.float32)},
                       "text": {"blocks": [{"w": np.ones(2, np.float32)}],
                                "token_embedding": np.ones(2, np.float32)},
                       "logit_scale": np.float32(1.0)},
              "classifier": {"fc1": {"kernel": np.ones(2, np.float32)}}}
    kw = dict(freeze_layers=0, epochs=4, lr=3e-4, betas=(0.0, 0.0), eps=0.0, weight_decay=0.0,
              grad_clip=0.0, skip_nonfinite_updates=False, warmup_steps=3)
    spe = 2
    jopt = j_make_optimizer(JTrainConfig(**kw), jax.tree.map(jnp.asarray, params), spe)
    jstate = jopt.init(jax.tree.map(jnp.asarray, params))
    topt = make_optimizer(TrainConfig(**kw), params_from_numpy(params), spe)
    ones = jax.tree.map(lambda a: jnp.ones_like(jnp.asarray(a)), params)
    where = {"visual": ("clip", "visual", "a"), "text": ("clip", "text", "blocks", 0, "w"),
             "other": ("clip", "text", "token_embedding"), "classifier": ("classifier", "fc1", "kernel")}
    for count in range(14):
        upd, jstate = jopt.update(ones, jstate, jax.tree.map(jnp.asarray, params))
        lrs = topt.learning_rates(count)
        for group, path in where.items():
            leaf = upd
            for k in path:
                leaf = leaf[k]
            assert lrs[group].dtype == torch.float32
            np.testing.assert_array_equal(-np.asarray(leaf)[0], lrs[group].numpy(), err_msg=f"{group} @ {count}")


@pytest.mark.parametrize("impl", ["infonce", "siglip"])
def test_combined_loss_values_and_grads_match_jax(impl):
    rng = np.random.default_rng(3)
    img = rng.standard_normal((6, 16)).astype(np.float32)
    txt = rng.standard_normal((6, 16)).astype(np.float32)
    img /= np.linalg.norm(img, axis=1, keepdims=True)
    txt /= np.linalg.norm(txt, axis=1, keepdims=True)
    logits = rng.standard_normal((6, 3)).astype(np.float32)
    labels = rng.integers(0, 3, 6).astype(np.int32)
    scale, bias = np.float32(2.3), np.float32(-4.0)

    def jloss(i, t, c, s, b):
        return jlosses.combined_clip_loss(i, t, s, class_logits=c, class_labels=jnp.asarray(labels),
                                          label_smoothing=0.1, contrastive_impl=impl, logit_bias=b)

    (jval, jmet), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
        *(jnp.asarray(a) for a in (img, txt, logits, scale, bias)))
    ts = [torch.tensor(a, requires_grad=True) for a in (img, txt, logits, scale, bias)]
    tval, tmet = combined_clip_loss(*ts[:2], ts[3], class_logits=ts[2],
                                    class_labels=torch.from_numpy(labels), label_smoothing=0.1,
                                    contrastive_impl=impl, logit_bias=ts[4])
    tval.backward()
    np.testing.assert_allclose(tval.item(), float(jval), rtol=1e-6)
    for k, v in jmet.items():
        np.testing.assert_allclose(tmet[k].item(), float(v), rtol=1e-6, err_msg=k)
    for t, g in zip(ts, jgrads):
        got = np.zeros_like(t.detach().numpy()) if t.grad is None else t.grad.numpy()
        np.testing.assert_allclose(got, np.asarray(g), rtol=1e-5, atol=1e-7)


def test_two_train_steps_loss_and_metrics_match_jax(two_steps):
    _, jm, _, tm, _ = two_steps
    for step in range(2):
        assert set(tm[step]) == set(jm[step])
        for k in jm[step]:
            if k != "grad_norm":
                np.testing.assert_allclose(tm[step][k], jm[step][k], rtol=1e-5, err_msg=f"{k} @ {step}")


def test_grad_norm_over_trainable_leaves_matches_jax(two_steps):
    _, jm, _, tm, _ = two_steps
    for step in range(2):
        np.testing.assert_allclose(tm[step]["grad_norm"], jm[step]["grad_norm"], rtol=1e-5)
        assert tm[step]["grad_norm"] > 1.0  # clipping at 1.0 was exercised


def test_updated_params_match_jax(two_steps):
    jstate, _, tstate, _, init = two_steps
    j = _flat_np(jax.tree.map(np.asarray, jstate.params))
    t = _flat_np(tstate.params)
    p0 = _flat_np(init)
    assert set(j) == set(t)
    for k in j:
        _assert_update_close(t[k] - p0[k], j[k] - p0[k], k)


def test_frozen_leaves_bit_unchanged_and_trainable_moved(two_steps):
    _, _, tstate, _, init = two_steps
    labels = flat_leaves(param_group_labels(params_from_numpy(init), 8))
    t, p0 = _flat_np(tstate.params), _flat_np(init)
    frozen = [k for k, lab in labels.items() if lab == "frozen"]
    assert len(frozen) == 16
    for k in labels:
        if labels[k] == "frozen":
            np.testing.assert_array_equal(t[k], p0[k])
        else:
            assert np.abs(t[k] - p0[k]).max() > 0, k
    assert set(tstate.opt_state["mu"]) == {k for k in labels if labels[k] != "frozen"}


def test_ema_matches_jax(two_steps):
    jstate, _, tstate, _, init = two_steps
    j = _flat_np(jax.tree.map(np.asarray, jstate.ema_params))
    t = _flat_np(tstate.ema_params)
    p0 = _flat_np(init)
    for k in j:
        _assert_update_close(t[k] - p0[k], j[k] - p0[k], k)


def test_bf16_mu_matches_optax():
    """adam_mu_dtype="bfloat16": mu stored in bf16, the update in fp32,
    three updates against optax."""
    rng = np.random.default_rng(7)
    params = {"clip": {"visual": {"a": rng.standard_normal(64).astype(np.float32)},
                       "logit_scale": np.float32(1.0)}}
    kw = dict(freeze_layers=0, adam_mu_dtype="bfloat16", lr=1e-2, weight_decay=0.1)
    jp = jax.tree.map(jnp.asarray, params)
    jopt = j_make_optimizer(JTrainConfig(**kw), jp)
    jstate = jopt.init(jp)
    tp = params_from_numpy(params)
    topt = make_optimizer(TrainConfig(**kw), tp)
    tstate = topt.init(tp)
    for _ in range(3):
        g = rng.standard_normal(64).astype(np.float32) * 0.1
        jg = {"clip": {"visual": {"a": jnp.asarray(g)}, "logit_scale": jnp.float32(0.05)}}
        upd, jstate = jopt.update(jg, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        topt.apply(tp, {"clip/visual/a": torch.from_numpy(g), "clip/logit_scale": torch.tensor(0.05)},
                   tstate)
    jmu = jstate.inner_state[1].inner_states["visual"].inner_state[0].mu
    tmu = tstate["mu"]["clip/visual/a"]
    assert tmu.dtype == torch.bfloat16
    np.testing.assert_array_equal(tmu.float().numpy(),
                                  np.asarray(jmu["clip"]["visual"]["a"].astype(jnp.float32)))
    np.testing.assert_allclose(tp["clip"]["visual"]["a"].numpy(), np.asarray(jp["clip"]["visual"]["a"]),
                               rtol=1e-6)


def test_nonfinite_updates_skipped_as_optax_apply_if_finite():
    """NaN gradients: skipped without advancing the count until more than
    max_consecutive_nonfinite in a row, then applied; a finite step resets
    the run."""
    params = {"clip": {"visual": {"a": np.ones(3, np.float32)}, "logit_scale": np.float32(1.0)}}
    kw = dict(freeze_layers=0, max_consecutive_nonfinite=2, lr=1e-2)
    jp = jax.tree.map(jnp.asarray, params)
    jopt = j_make_optimizer(JTrainConfig(**kw), jp)
    jstate = jopt.init(jp)
    tp = params_from_numpy(params)
    topt = make_optimizer(TrainConfig(**kw), tp)
    tstate = topt.init(tp)
    nan = np.array([1.0, np.nan, 2.0], np.float32)
    fine = np.array([1.0, -1.0, 0.5], np.float32)
    for g in (nan, nan, fine, nan, nan, nan):
        jg = {"clip": {"visual": {"a": jnp.asarray(g)}, "logit_scale": jnp.float32(0.5)}}
        upd, jstate = jopt.update(jg, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        applied = topt.apply(tp, {"clip/visual/a": torch.from_numpy(g),
                                  "clip/logit_scale": torch.tensor(0.5)}, tstate)
        assert tstate["notfinite_count"] == int(jstate.notfinite_count)
        assert tstate["total_notfinite"] == int(jstate.total_notfinite)
        assert applied == (bool(jstate.last_finite) or int(jstate.notfinite_count) > 2)
        np.testing.assert_allclose(tp["clip"]["visual"]["a"].numpy(), np.asarray(jp["clip"]["visual"]["a"]),
                                   rtol=1e-6)
    assert tstate["count"] == 2  # the fine step and the forced one
    assert np.isnan(tp["clip"]["visual"]["a"].numpy()[1])
