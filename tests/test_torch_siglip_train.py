"""The port's SigLIP trainer against the JAX package's
(``tests/test_siglip_train.py``): the first step's loss and gradients, the
optimizer (clip by global norm, then AdamW), a few steps' losses and
updates, the step over a 2-slot data mesh against one slot, and that both
towers and ``logit_bias`` move.

JAX's tiny geometry, its params carried across, both on the CPU in fp32.
Tolerances: gradients within 5e-3 of each leaf's largest entry; losses
rtol 1e-5; Adam's updates by cosine (≥ 0.999 a leaf), as the port's other
trainer tests hold them; the mesh step against one slot at JAX's bounds
(rtol 1e-4, atol 1e-6).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from evr_tpu.models import siglip as js
from evr_tpu.parallel.contrastive import siglip_loss_single as jloss
from evr_tpu.training import siglip_train as jtrain
from evr_tpu_torch.models import siglip as ts
from evr_tpu_torch.models.convert import params_from_numpy
from evr_tpu_torch.parallel import get_mesh
from evr_tpu_torch.training import siglip_train as ttrain
from evr_tpu_torch.training.finetune import flat_leaves
from torch_threads import one_torch_thread  # noqa: F401

GRAD_TOL = 5e-3
UPDATE_COS = 0.999


def _cfg(mod):
    return mod.SiglipConfig(
        vision=mod.SiglipVisionConfig(image_size=32, patch_size=16, width=32, layers=1, heads=2, mlp_dim=64),
        text=mod.SiglipTextConfig(context_length=8, vocab_size=60, width=32, layers=1, heads=2, mlp_dim=64),
    )


def _params(seed):
    return jax.tree.map(np.asarray, js.init_siglip_params(jax.random.PRNGKey(seed), _cfg(js)))


def _batch(seed, n=8):
    rng = np.random.default_rng(seed)
    return {"images": rng.integers(0, 256, (n, 32, 32, 3), dtype=np.uint8),
            "tokens": rng.integers(1, 60, (n, 8)).astype(np.int32)}


def _flat_np(tree) -> dict:
    return {k: np.asarray(v.detach() if hasattr(v, "detach") else v) for k, v in flat_leaves(tree).items()}


def _jax_flat(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): np.asarray(v)
            for path, v in leaves}


def _jax_loss_and_grads(params, batch):
    cfg = _cfg(js)

    def loss_fn(p):
        pixels = jnp.asarray(batch["images"]).astype(jnp.float32) * (2.0 / 255.0) - 1.0
        img = js.encode_image(p, cfg, pixels)
        txt = js.encode_text(p, cfg, jnp.asarray(batch["tokens"]))
        img = img / jnp.linalg.norm(img, axis=-1, keepdims=True)
        txt = txt / jnp.linalg.norm(txt, axis=-1, keepdims=True)
        return jloss(img, txt, p["logit_scale"], p["logit_bias"])

    loss, grads = jax.value_and_grad(loss_fn)(jax.tree.map(jnp.asarray, params))
    return float(loss), _jax_flat(grads)


def test_first_step_loss_and_gradients_match_jax():
    params, batch = _params(0), _batch(0)
    jl, jg = _jax_loss_and_grads(params, batch)
    loss, grads = ttrain.siglip_grads(params_from_numpy(params), _cfg(ts), batch)
    np.testing.assert_allclose(float(loss), jl, rtol=1e-5)
    assert set(grads) == set(jg)
    for k, g in grads.items():
        scale = max(float(np.abs(jg[k]).max()), 1e-12)
        np.testing.assert_allclose(g.numpy() / scale, jg[k] / scale, rtol=0, atol=GRAD_TOL, err_msg=k)
    assert float(grads["logit_bias"]) != 0.0


def test_optimizer_matches_optax():
    """clip_by_global_norm → adamw, and adamw alone at grad_clip 0, against
    optax's updates on the same gradients (a huge one clipped)."""
    rng = np.random.default_rng(2)
    for clip, size in ((0.5, 1e6), (0.0, 1.0)):
        tc = ttrain.SiglipTrainConfig(lr=1e-3, grad_clip=clip)
        params = {"w": rng.standard_normal((4, 4)).astype(np.float32), "b": np.float32(0.3)}
        grads = [{"w": rng.standard_normal((4, 4)).astype(np.float32) * size,
                  "b": np.float32(size)} for _ in range(2)]
        opt = jtrain.make_siglip_optimizer(jtrain.SiglipTrainConfig(lr=1e-3, grad_clip=clip))
        jp = jax.tree.map(jnp.asarray, params)
        state = opt.init(jp)
        topt = ttrain.make_siglip_optimizer(tc)
        tp = params_from_numpy(params)
        tstate = topt.init(tp)
        for g in grads:
            updates, state = opt.update(jax.tree.map(jnp.asarray, g), state, jp)
            jp = optax.apply_updates(jp, updates)
            topt.apply(tp, {k: torch.from_numpy(np.asarray(v)) for k, v in g.items()}, tstate)
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7, err_msg=(clip, k))
        if clip:
            assert float(np.abs(tp["w"].numpy() - params["w"]).max()) < 1e-2


def test_fit_descends_moves_both_towers_and_matches_jax():
    """Four steps at lr 3e-4 on one batch: the losses fall and equal JAX's
    (rtol 1e-4), each leaf's update points where JAX's does (cosine), and
    both towers and the sigmoid parameters move."""
    params, batch = _params(0), _batch(0)
    tc = dict(lr=3e-4)
    jtrained, jlosses = jtrain.fit_siglip(params, _cfg(js), [batch] * 4, jtrain.SiglipTrainConfig(**tc))
    trained, losses = ttrain.fit_siglip(params, _cfg(ts), [batch] * 4, ttrain.SiglipTrainConfig(**tc),
                                        device="cpu")
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    before, after, jafter = _flat_np(params_from_numpy(params)), _flat_np(trained), _jax_flat(jtrained)
    for k in before:
        u, ju = (after[k] - before[k]).ravel(), (jafter[k] - before[k]).ravel()
        cos = float(u @ ju / max(np.linalg.norm(u) * np.linalg.norm(ju), 1e-30))
        assert cos >= UPDATE_COS, (k, cos)
    for tower in ("visual", "text"):
        k = f"{tower}/blocks/0/mlp/fc/kernel"
        assert not np.allclose(after[k], before[k])
    assert float(trained["logit_bias"]) != -10.0
    # the caller's params are untouched
    np.testing.assert_array_equal(_flat_np(params_from_numpy(params))["logit_bias"], np.float32(-10.0))


def test_mesh_step_matches_one_slot():
    """One step over a 2-slot CPU data mesh equals the same global batch on
    one slot (the sigmoid loss has no softmax over the batch), and JAX's
    one-device step."""
    params, batch = _params(1), _batch(1, n=16)
    tc = ttrain.SiglipTrainConfig(lr=1e-4)
    results = [ttrain.fit_siglip(params, _cfg(ts), [batch], tc, mesh=mesh, device="cpu")
               for mesh in (None, get_mesh(2, device="cpu"))]
    jtrained, jlosses = jtrain.fit_siglip(params, _cfg(js), [batch], jtrain.SiglipTrainConfig(lr=1e-4))
    (p1, l1), (p2, l2) = results
    np.testing.assert_allclose(l2[0], l1[0], rtol=1e-5)
    np.testing.assert_allclose(l1[0], jlosses[0], rtol=1e-5)
    f1, f2, jf = _flat_np(p1), _flat_np(p2), _jax_flat(jtrained)
    for k in f1:
        np.testing.assert_allclose(f2[k], f1[k], rtol=1e-4, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(f1[k], jf[k], rtol=1e-4, atol=1e-6, err_msg=k)
    with pytest.raises(ValueError, match="do not split"):
        ttrain.siglip_grads(params_from_numpy(params), _cfg(ts), _batch(2, n=3), mesh=get_mesh(2, device="cpu"))
