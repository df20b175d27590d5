"""The port's GradCache (``training.gradcache``, the Trainer's
``gradcache_chunks``) against ``evr_tpu.training.gradcache`` on the CPU.

The helper against direct autograd on a toy encoder; GradCache train steps
(InfoNCE with four chunks over two steps, SigLIP with two over one) against
JAX's GradCache steps from the same seeded params and batches (fp32,
classifier dropout 0) at JAX's own tolerances (params 2e-4 relative, 2e-5
absolute; losses 1e-4), InfoNCE's gradients at 5e-3, and the port's chunked
gradients against its direct ones (chunking reorders sums only).
"""

import numpy as np
import pytest
import torch

from evr_tpu_torch.models.convert import params_from_numpy
from evr_tpu_torch.training import TrainConfig, chunk_batch, gradcache_value_and_grad, make_grad_fn

from torch_trainer_twins import (
    TCLS, assert_close_rel, cfgs, jax_gradients, jax_steps, np_params, port_gradients, port_steps, tiny_batch,
)
from torch_threads import one_torch_thread  # noqa: F401

BASE = dict(batch_size=8, epochs=2, compute_dtype="float32", freeze_layers=8)


def test_chunk_batch_shapes_order_and_divisibility():
    b = {"a": torch.arange(24).reshape(8, 3), "t": torch.arange(8)}
    c = chunk_batch(b, 4)
    assert len(c) == 4 and c[1]["a"].shape == (2, 3) and c[3]["t"].tolist() == [6, 7]
    assert torch.equal(torch.cat([x["a"] for x in c]), b["a"])
    with pytest.raises(ValueError, match="not divisible"):
        chunk_batch(b, 3)


def test_helper_matches_direct_autograd():
    """A toy encoder and an InfoNCE-shaped head: the chunked gradients of
    every leaf (the encoder's and the head's own) equal autograd's on the
    whole batch."""
    g = torch.Generator().manual_seed(0)
    w = torch.randn(8, 4, generator=g, requires_grad=True)
    scale = torch.tensor(1.5, requires_grad=True)
    x = torch.randn(12, 8, generator=g)

    def encode_fn(cb):
        return {"e": torch.tanh(cb["x"] @ w)}

    def head_fn(emb, aux):
        logits = scale * emb["e"] @ emb["e"].T
        loss = -torch.log_softmax(logits, dim=-1).diagonal().mean()
        return loss, {"loss": loss}

    loss_d, _ = head_fn(encode_fn({"x": x}), None)
    g_d = torch.autograd.grad(loss_d, [w, scale])
    (loss_c, metrics), g_c = gradcache_value_and_grad(encode_fn, head_fn, 3)({"x": x}, None,
                                                                             {"w": w, "scale": scale})
    assert abs(loss_d.item() - loss_c.item()) < 1e-6 and set(metrics) == {"loss"}
    torch.testing.assert_close(g_c["w"], g_d[0], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(g_c["scale"], g_d[1], rtol=1e-5, atol=1e-6)


def _siglip_params():
    params = np_params()
    params["clip"]["logit_bias"] = np.float32(-10.0)
    return params


@pytest.mark.parametrize("loss, chunks, n_steps", [("infonce", 4, 2), ("siglip", 2, 1)])
def test_gradcache_steps_match_jax(loss, chunks, n_steps):
    kw = dict(BASE, contrastive_loss=loss, gradcache_chunks=chunks)
    params = _siglip_params() if loss == "siglip" else np_params()
    rng = np.random.default_rng(0)
    batches = [tiny_batch(rng) for _ in range(n_steps)]
    jm, jafter, _ = jax_steps(kw, params, batches)
    tm, tafter, _ = port_steps(kw, params, batches)
    for s in range(n_steps):
        assert abs(tm[s]["total_loss"] - jm[s]["total_loss"]) < 1e-4
        for k in jafter[s]:
            np.testing.assert_allclose(tafter[s][k], jafter[s][k], rtol=2e-4, atol=2e-5, err_msg=k)
    if loss == "infonce":
        _, jg = jax_gradients(kw, params, batches[0])
        _, tg = port_gradients(kw, params, batches[0])
        assert assert_close_rel(tg, jg, what="gradients") > 20


def test_chunked_gradients_equal_the_direct_step():
    params = np_params()
    batch = tiny_batch(np.random.default_rng(1))
    md, gd = port_gradients(BASE, params, batch)
    mc, gc = port_gradients(dict(BASE, gradcache_chunks=4), params, batch)
    assert set(gc) == set(gd) and abs(mc["total_loss"] - md["total_loss"]) < 1e-5
    assert set(mc) == set(md)
    assert assert_close_rel(gc, gd, 1e-4, "chunked vs direct") == sum(1 for v in gd.values() if v.any())


def test_gradcache_refuses_lora_and_patch_drop():
    _, tcfg = cfgs()
    for bad in (dict(lora_rank=4), dict(patch_drop=0.5)):
        with pytest.raises(ValueError, match="gradcache"):
            make_grad_fn(tcfg, TCLS, TrainConfig(gradcache_chunks=2, **bad))
    make_grad_fn(tcfg, TCLS, TrainConfig(gradcache_chunks=2, remat=True))  # composes with remat
    with pytest.raises(ValueError, match="not divisible"):
        fn = make_grad_fn(tcfg, TCLS, TrainConfig(gradcache_chunks=3, **BASE))
        fn(params_from_numpy(np_params()), tiny_batch(np.random.default_rng(2)))
