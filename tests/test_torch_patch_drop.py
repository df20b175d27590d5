"""The port's FLIP patch drop (``encode_image(patch_keep=)``, the Trainer's
``patch_drop``) against ``evr_tpu`` on the CPU.

``encode_image`` with the same unsorted keep indices as JAX's, fp32, within
1e-5; train steps with JAX's keep masks handed to the port
(``finetune.draw_patch_keep`` replaced by the JAX step's own draw: a split
of the step key, uniforms, an argsort) at 5e-3 (gradients and updates,
classifier dropout 0); the evaluation step runs the full sequence; the keep
count's Python rounding, and the block route at the cut sequence length
(the kernel route only at T ≥ 512, as the JAX trainer routes it).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from evr_tpu.models import clip as jclip
from evr_tpu_torch.models import clip as tclip
from evr_tpu_torch.models import layers as tlayers
from evr_tpu_torch.models.convert import params_from_numpy
from evr_tpu_torch.training import TrainConfig, make_grad_fn
from evr_tpu_torch.training import finetune as tf

from torch_trainer_twins import (
    TCLS, assert_close_rel, cfgs, jax_gradients, jax_steps, np_params, port_gradients, port_steps, tiny_batch,
    to_np, updates,
)

STEP = dict(patch_drop=0.5, lr=1e-3, batch_size=8, epochs=2, compute_dtype="float32", freeze_layers=0)


def jax_keep(key: int, batch: int, n_patches: int, n_keep: int) -> np.ndarray:
    """The JAX trainer's keep indices for the step key ``PRNGKey(key)``."""
    _, drop_rng = jax.random.split(jax.random.PRNGKey(key))
    u = jax.random.uniform(drop_rng, (batch, n_patches))
    return np.array(jnp.argsort(u, axis=-1)[:, :n_keep].astype(jnp.int32))  # a writable copy


@pytest.fixture
def jax_masks(monkeypatch):
    """``draw_patch_keep`` handing out the JAX steps' masks, keys 0, 1, ...
    in order."""
    calls = []

    def draw(generator, batch, n_patches, n_keep, device):
        keep = jax_keep(len(calls), batch, n_patches, n_keep)
        calls.append(keep)
        return torch.from_numpy(keep).to(device)

    monkeypatch.setattr(tf, "draw_patch_keep", draw)
    return calls


def _pixels(rng, n=3):
    return rng.normal(size=(n, 32, 32, 3)).astype(np.float32)


def test_identity_keep_equals_the_full_forward_and_dropped_patches_do_not_count():
    _, tcfg = cfgs("xla")
    params = params_from_numpy(np_params()["clip"])
    x = torch.from_numpy(_pixels(np.random.default_rng(0)))
    keep_all = torch.arange(16).expand(3, 16)
    torch.testing.assert_close(tclip.encode_image(params, tcfg, x, patch_keep=keep_all),
                               tclip.encode_image(params, tcfg, x), rtol=1e-6, atol=1e-6)
    corrupted = x.clone()
    corrupted[:, 16:, 16:, :] = 99.0  # the bottom-right quadrant: patches with x, y >= 2
    keep = torch.tensor([[0, 1, 4, 5]] * 3)
    torch.testing.assert_close(tclip.encode_image(params, tcfg, corrupted, patch_keep=keep),
                               tclip.encode_image(params, tcfg, x, patch_keep=keep), rtol=1e-6, atol=1e-6)


def test_encode_image_with_unsorted_keep_matches_jax():
    jcfg, tcfg = cfgs("xla")
    np_clip = np_params()["clip"]
    x = _pixels(np.random.default_rng(1), 4)
    keep = jax_keep(3, 4, 16, 11)
    assert (np.diff(keep, axis=1) < 0).any()  # unsorted, and kept so
    ref = np.asarray(jclip.encode_image(jax.tree.map(jnp.asarray, np_clip), jcfg, jnp.asarray(x),
                                        patch_keep=jnp.asarray(keep)))
    for impl in ("xla", "plain"):
        got = tclip.encode_image(params_from_numpy(np_clip), dataclasses.replace(tcfg, attn_impl=impl),
                                 torch.from_numpy(x), patch_keep=torch.from_numpy(keep)).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6, err_msg=impl)


def test_steps_with_jax_masks_match_jax(jax_masks):
    params = np_params()
    rng = np.random.default_rng(2)
    batches = [tiny_batch(rng) for _ in range(2)]
    jm, jafter, _ = jax_steps(STEP, params, batches)
    tm, tafter, _ = port_steps(STEP, params, batches)
    assert len(jax_masks) == 2 and jax_masks[0].shape == (8, 8)
    before = to_np(params)
    for s in range(2):
        np.testing.assert_allclose(tm[s]["total_loss"], jm[s]["total_loss"], rtol=1e-5)
        np.testing.assert_allclose(tm[s]["grad_norm"], jm[s]["grad_norm"], rtol=1e-4)
        prev_t, prev_j = (before, before) if s == 0 else (tafter[s - 1], jafter[s - 1])
        assert assert_close_rel(updates(tafter[s], prev_t), updates(jafter[s], prev_j), what=f"step {s}") > 50
    jax_masks.clear()
    _, jg = jax_gradients(STEP, params, batches[0])
    _, tg = port_gradients(STEP, params, batches[0])
    assert assert_close_rel(tg, jg, what="gradients") > 50


def test_mask_draw_comes_before_the_classifier_dropout():
    """The step's generator draws the keep mask first: with classifier
    dropout on, a generator advanced by one mask's draw reproduces the
    step's loss (the dropout draw follows the mask's)."""
    _, tcfg = cfgs()
    from evr_tpu_torch.models.classifier import ClassifierConfig

    cls = ClassifierConfig(embed_dim=32, num_classes=3, dropout=0.5)
    params = params_from_numpy(np_params())
    batch = tiny_batch(np.random.default_rng(3))
    fn = make_grad_fn(tcfg, cls, TrainConfig(**STEP))
    m1, _ = fn(params, batch, torch.Generator().manual_seed(7))
    gen = torch.Generator().manual_seed(7)
    keep = tf.draw_patch_keep(gen, 8, 16, 8, "cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tf, "draw_patch_keep", lambda *a: keep)
        m2, _ = make_grad_fn(tcfg, cls, TrainConfig(**STEP))(params, batch, gen)
    assert m1["total_loss"] == m2["total_loss"]


def test_eval_step_ignores_patch_drop():
    jcfg, tcfg = cfgs()
    params = np_params()
    batch = tiny_batch(np.random.default_rng(4))
    full = make_grad_fn(tcfg, TCLS, TrainConfig(**dict(STEP, patch_drop=0.0)))(
        params_from_numpy(params), batch, train=False)[0]
    dropped = make_grad_fn(tcfg, TCLS, TrainConfig(**STEP))(params_from_numpy(params), batch, train=False)[0]
    assert {k: v.item() for k, v in full.items()} == {k: v.item() for k, v in dropped.items()}
    from evr_tpu.training import TrainConfig as JTrainConfig
    from evr_tpu.training import make_optimizer as j_make_optimizer
    from evr_tpu.training import make_train_step as j_make_train_step
    from evr_tpu.training.finetune import TrainState as JTrainState

    from torch_trainer_twins import JCLS

    jp = jax.tree.map(jnp.asarray, params)
    jopt = j_make_optimizer(JTrainConfig(**STEP), jp)
    _, jeval = j_make_train_step(jcfg, JCLS, JTrainConfig(**STEP), jopt)
    jmet = jeval(JTrainState(params=jp, opt_state=jopt.init(jp), step=jnp.zeros((), jnp.int32)),
                 {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(dropped["total_loss"].item(), float(jmet["total_loss"]), rtol=1e-5)


@pytest.mark.parametrize("grid, drop, keep", [(24, 0.1, 518), (24, 0.5, 288), (4, 0.15625, 14),
                                              (4, 0.21875, 12), (4, 0.99, 1)])
def test_keep_count_rounds_as_python(grid, drop, keep):
    cfg = tclip.CLIPConfig(vision=tclip.VisionConfig(image_size=grid * 2, patch_size=2))
    assert tf.patch_keep_count(cfg, drop) == (grid * grid, keep)
    assert keep == max(1, int(round(grid * grid * (1.0 - drop))))  # the JAX trainer's formula


@pytest.mark.parametrize("drop, kernel_route", [(0.1, True), (0.5, False)])
def test_route_at_the_cut_sequence_length(monkeypatch, drop, kernel_route):
    """ViT-L/14@336px's grid (576 patches): patch_drop 0.1 keeps T = 519,
    where the training route takes the fused block (here its plain versions,
    "plain_grad"); 0.5 keeps T = 289, which runs the plain composition, as
    in the JAX package (the kernels only at T ≥ 512)."""
    calls = []
    real = tlayers.plain_block_apply
    monkeypatch.setattr(tlayers, "plain_block_apply", lambda x, *a, **k: calls.append(x.shape[1]) or real(x, *a, **k))
    geom = dict(width=64, layers=1, heads=4)
    cfg = tclip.CLIPConfig(embed_dim=32, vision=tclip.VisionConfig(image_size=48, patch_size=2, **geom),
                           text=tclip.TextConfig(context_length=16, vocab_size=600, **geom),
                           attn_impl="plain_grad")
    params = params_from_numpy({"clip": tclip.init_clip_params(0, cfg)})
    rng = np.random.default_rng(5)
    batch = {"images": (rng.random((2, 48, 48, 3)) * 255).astype(np.uint8), "tokens": tiny_batch(rng, 2)["tokens"]}
    fn = make_grad_fn(cfg, None, TrainConfig(patch_drop=drop, freeze_layers=0, compute_dtype="float32"))
    metrics, grads = fn(params, batch, torch.Generator().manual_seed(0))
    assert np.isfinite(metrics["total_loss"].item())
    assert calls == ([1 + tf.patch_keep_count(cfg, drop)[1]] if kernel_route else [])
