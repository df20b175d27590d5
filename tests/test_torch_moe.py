"""The port's MoE towers (``evr_tpu_torch.models.moe``) against
``evr_tpu.models.moe`` on the CPU.

Seeded params drawn by the JAX package and carried across; fp32. The MoE
layer at three group sizes with a capacity small enough to drop tokens
(1e-5), its gradients for the experts, the router and the input against
``jax.grad`` (5e-3 relative L2), the aux loss of a router that cannot
choose (exactly 1), Sparse Upcycling's step-0 equality with the dense
towers, the towers and ``moe_clip_forward`` (1e-5), the forced ``"fused"``
attention half (K1's plain version on a CPU tensor) against ``"xla"``, and
remat bit-equal to no remat.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from evr_tpu.models import moe as jm
from evr_tpu.models.variants import get_model_config as j_config
from evr_tpu_torch.models import clip as tclip
from evr_tpu_torch.models import moe as tm
from evr_tpu_torch.models.convert import params_from_numpy
from evr_tpu_torch.models.variants import get_model_config as t_config

from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5
MODEL = "ViT-Tiny-Test"


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def port_moe(cfg: jm.MoEConfig) -> tm.MoEConfig:
    return tm.MoEConfig(**dataclasses.asdict(cfg))


def tokens(n: int, rng) -> np.ndarray:
    t = np.zeros((n, 77), np.int32)
    for i in range(n):
        ln = int(rng.integers(2, 9))
        t[i, 0] = 49406
        t[i, 1:ln] = rng.integers(1, 49000, size=ln - 1)
        t[i, ln] = 49407
    return t


@pytest.fixture(scope="module")
def towers():
    """A ViT-Tiny-Test MoE tree (4 distinct experts, top-2, every block
    sparse) drawn by the JAX package, and inputs."""
    moe = jm.MoEConfig(n_experts=4, router_k=2, capacity_factor=1.0, moe_every=1, group_size=48)
    jp = jm.init_moe_clip_params(jax.random.PRNGKey(0), j_config(MODEL), moe)
    rng = np.random.default_rng(0)
    pixels = rng.normal(size=(4, 64, 64, 3)).astype(np.float32)
    return moe, to_np(jp), pixels, tokens(4, rng)


@pytest.mark.parametrize("group_size", [4, 16, 256])
def test_moe_mlp_matches_jax_with_overflow(group_size):
    """Grouped dispatch at three group sizes (S = the largest divisor of the
    30 tokens ≤ group_size: 3, 15, 30) with capacity 0.5: tokens overflow
    and are dropped in both packages alike."""
    cfg = jm.MoEConfig(n_experts=4, router_k=2, capacity_factor=0.5, group_size=group_size)
    p = to_np(jm.init_moe_mlp(jax.random.PRNGKey(1), 32, 2, 4))
    p["router"]["kernel"] = p["router"]["kernel"] * 50  # confident, uneven routing
    x = np.random.default_rng(group_size).normal(size=(3, 10, 32)).astype(np.float32)
    yj, aj = jax.jit(lambda x, p: jm.moe_mlp_apply(x, p, cfg))(x, p)
    yt, at = tm.moe_mlp_apply(torch.from_numpy(x), params_from_numpy(p), port_moe(cfg))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=TOL)
    np.testing.assert_allclose(float(at), float(aj), rtol=TOL)
    # some token of the batch is dropped (its MoE output is exactly zero)
    S = tm.moe_group(30, group_size)
    assert S == {4: 3, 16: 15, 256: 30}[group_size]
    assert (np.abs(yt.numpy().reshape(30, 32)).max(axis=-1) == 0).any()


def test_ties_route_to_the_lower_expert():
    """A router whose columns are equal: every gate ties, and both packages
    send every token to experts 0 and 1 (``lax.top_k``'s order)."""
    cfg = jm.MoEConfig(n_experts=4, router_k=2, capacity_factor=4.0, group_size=8)
    p = to_np(jm.init_moe_mlp(jax.random.PRNGKey(2), 16, 2, 4))
    p["router"]["kernel"] = np.repeat(p["router"]["kernel"][:, :1], 4, axis=1)
    for a in ("fc", "proj"):  # one expert four times, told apart by the fc bias alone
        p[a]["kernel"] = np.repeat(p[a]["kernel"][:1], 4, axis=0)
    p["fc"]["bias"] = np.arange(4, dtype=np.float32)[:, None].repeat(64, 1)
    x = np.random.default_rng(1).normal(size=(2, 4, 16)).astype(np.float32)
    yj, aj = jm.moe_mlp_apply(jnp.asarray(x), p, cfg)
    yt, at = tm.moe_mlp_apply(torch.from_numpy(x), params_from_numpy(p), port_moe(cfg))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=TOL)
    q = dict(p, fc=dict(p["fc"], bias=p["fc"]["bias"][[1, 0, 2, 3]]))  # experts 0 and 1 swapped
    swapped, _ = tm.moe_mlp_apply(torch.from_numpy(x), params_from_numpy(q), port_moe(cfg))
    np.testing.assert_allclose(swapped.numpy(), yt.numpy(), rtol=0, atol=TOL)  # both chosen, equal gates
    q = dict(p, fc=dict(p["fc"], bias=p["fc"]["bias"][[2, 1, 0, 3]]))
    assert np.abs(tm.moe_mlp_apply(torch.from_numpy(x), params_from_numpy(q), port_moe(cfg))[0].numpy()
                  - yt.numpy()).max() > 1e-3  # expert 2 was never chosen


def test_balanced_router_aux_is_one():
    """A zero router: uniform probabilities, so E · Σ f·P = 1 whatever the
    first choices, in both packages."""
    cfg = jm.MoEConfig(n_experts=8, router_k=2, group_size=16)
    p = to_np(jm.init_moe_mlp(jax.random.PRNGKey(3), 16, 2, 8))
    p["router"]["kernel"] = np.zeros_like(p["router"]["kernel"])
    x = np.random.default_rng(2).normal(size=(2, 16, 16)).astype(np.float32)
    _, at = tm.moe_mlp_apply(torch.from_numpy(x), params_from_numpy(p), port_moe(cfg))
    _, aj = jm.moe_mlp_apply(jnp.asarray(x), p, cfg)
    assert float(at) == pytest.approx(1.0, abs=1e-6) and float(aj) == pytest.approx(1.0, abs=1e-6)


def test_gradients_match_jax():
    """d/dθ of Σ y·w + aux for the experts, the router and the input."""
    cfg = jm.MoEConfig(n_experts=4, router_k=2, capacity_factor=1.0, group_size=10)
    p = to_np(jm.init_moe_mlp(jax.random.PRNGKey(4), 32, 2, 4))
    p["router"]["kernel"] = p["router"]["kernel"] * 20
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 10, 32)).astype(np.float32)
    w = rng.normal(size=(2, 10, 32)).astype(np.float32)

    def jloss(p, x):
        y, aux = jm.moe_mlp_apply(x, p, cfg)
        return jnp.sum(y * w) + aux

    gj_p, gj_x = jax.jit(jax.grad(jloss, argnums=(0, 1)))(p, x)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)).requires_grad_(True), p)
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = tm.moe_mlp_apply(tx, tp, port_moe(cfg))
    (torch.sum(y * torch.from_numpy(w)) + aux).backward()
    pairs = [(tx.grad, gj_x)] + [(tp[a][b].grad, gj_p[a][b]) for a in ("fc", "proj") for b in ("kernel", "bias")]
    pairs.append((tp["router"]["kernel"].grad, gj_p["router"]["kernel"]))
    for got, ref in pairs:
        ref = np.asarray(ref)
        assert np.abs(ref).max() > 0
        assert np.linalg.norm(got.numpy() - ref) <= 5e-3 * np.linalg.norm(ref)


def test_moe_clip_forward_matches_jax(towers):
    moe, jp, pixels, toks = towers
    cfg = j_config(MODEL)
    oj = jax.jit(lambda p, x, t: jm.moe_clip_forward(p, cfg, moe, x, t))(jp, pixels, toks)
    ot = tm.moe_clip_forward(params_from_numpy(jp), t_config(MODEL), port_moe(moe), torch.from_numpy(pixels),
                             torch.from_numpy(toks))
    assert set(ot) == set(oj)
    for k in oj:
        np.testing.assert_allclose(ot[k].numpy(), np.asarray(oj[k]), rtol=0, atol=TOL, err_msg=k)
    assert float(ot["aux_loss"]) > 1.0  # learned routers are not uniform
    # FLIP patch masking composes as in clip.encode_image
    keep = np.stack([np.random.default_rng(i).permutation(16)[:6] for i in range(4)]).astype(np.int32)
    ij, aj = jax.jit(lambda p, x, k: jm.encode_image_moe(p, cfg, moe, x, patch_keep=k))(jp, pixels, keep)
    it, at = tm.encode_image_moe(params_from_numpy(jp), t_config(MODEL), port_moe(moe), torch.from_numpy(pixels),
                                 patch_keep=torch.from_numpy(keep))
    np.testing.assert_allclose(it.numpy(), np.asarray(ij), rtol=0, atol=TOL)
    np.testing.assert_allclose(float(at), float(aj), rtol=TOL)


def test_upcycled_towers_equal_the_dense_ones_at_step_0():
    """Identical experts under renormalised top-2 with room for every token
    (capacity factor E/k): the MoE towers compute the dense towers'
    features; the port's routers come from a torch.Generator."""
    cfg = t_config(MODEL)
    dense = tclip.init_clip_params(5, cfg)
    moe = tm.MoEConfig(n_experts=4, router_k=2, capacity_factor=2.0, moe_every=1)
    up = params_from_numpy(tm.upcycle_clip_params(torch.Generator().manual_seed(0), dense, cfg, moe))
    assert tm.has_moe(up) and all("moe" in b and "mlp" not in b for b in up["visual"]["blocks"])
    dense_t = params_from_numpy(dense)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(3, 64, 64, 3)).astype(np.float32))
    t = torch.from_numpy(tokens(3, rng))
    np.testing.assert_allclose(tm.encode_image_moe(up, cfg, moe, x)[0].numpy(),
                               tclip.encode_image(dense_t, cfg, x).numpy(), rtol=0, atol=TOL)
    np.testing.assert_allclose(tm.encode_text_moe(up, cfg, moe, t)[0].numpy(),
                               tclip.encode_text(dense_t, cfg, t).numpy(), rtol=0, atol=TOL)
    # the JAX package's upcycling makes the same experts (its routers differ)
    ju = to_np(jm.upcycle_clip_params(jax.random.PRNGKey(0), dense, j_config(MODEL),
                                      jm.MoEConfig(n_experts=4, router_k=2, moe_every=1)))
    for tower in ("visual", "text"):
        for b_t, b_j in zip(up[tower]["blocks"], ju[tower]["blocks"]):
            for a in ("fc", "proj"):
                np.testing.assert_array_equal(b_t["moe"][a]["kernel"].numpy(), b_j["moe"][a]["kernel"])


def test_fused_attention_half_equals_xla_on_the_cpu(towers):
    """``attn_impl="fused"`` forces K1, whose plain version runs on a CPU
    tensor; ``"plain"`` is K1's plain version on any device; both equal
    the plain composition ``"xla"``. ``"auto_grad"`` resolves to ``"xla"``."""
    moe, jp, _, _ = towers
    block = params_from_numpy(jp)["visual"]["blocks"][-1]
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(2, 17, 64)).astype(np.float32))
    ref, aux = tm.moe_block_apply(x, block, 4, port_moe(moe), attn_impl="xla")
    for impl in ("fused", "plain", "auto", "auto_grad", "plain_grad"):
        got, got_aux = tm.moe_block_apply(x, block, 4, port_moe(moe), attn_impl=impl)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=TOL, err_msg=impl)
        np.testing.assert_allclose(float(got_aux), float(aux), rtol=TOL)
    assert tm.moe_block_indices(12, 2) == jm.moe_block_indices(12, 2) == (1, 3, 5, 7, 9, 11)
    assert tm.moe_block_indices(5, 3) == jm.moe_block_indices(5, 3)


def test_remat_is_bit_equal_and_init_shapes_match_jax(towers):
    """``CLIPConfig.remat`` recomputes each block in the backward: the
    gradients are bit-equal to no remat's. ``init_moe_clip_params`` builds
    the JAX package's tree (paths and shapes)."""
    moe, jp, pixels, _ = towers
    cfg = t_config(MODEL)
    grads = []
    for remat in (False, True):
        p = jax.tree.map(lambda a: torch.from_numpy(np.array(a)).requires_grad_(True), jp)
        img, aux = tm.encode_image_moe(p, dataclasses.replace(cfg, remat=remat), port_moe(moe),
                                       torch.from_numpy(pixels))
        (img.square().sum() + aux).backward()
        grads.append(p["visual"]["blocks"][0]["moe"]["fc"]["kernel"].grad.numpy().copy())
    np.testing.assert_array_equal(grads[0], grads[1])
    mine = tm.init_moe_clip_params(0, cfg, port_moe(moe))
    shapes = jax.tree.map(lambda a: tuple(np.shape(a)), jp)
    assert jax.tree.map(lambda a: tuple(np.shape(a)), jax.tree.map(np.asarray, mine)) == shapes
    router = mine["visual"]["blocks"][0]["moe"]["router"]["kernel"]
    assert 0.015 < float(router.std()) < 0.025
    block = tm.init_moe_block(torch.Generator().manual_seed(1), 64, 2, 4)
    assert jax.tree.map(lambda a: tuple(np.shape(a)), jax.tree.map(np.asarray, block)) == \
        jax.tree.map(lambda a: tuple(np.shape(a)), jm.init_moe_block(jax.random.PRNGKey(1), 64, 2, 4))
