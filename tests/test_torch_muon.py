"""The port's Muon (``training.muon``, the Trainer's ``optimizer="muon"``)
against ``evr_tpu.training.muon`` on the CPU.

Newton–Schulz in bf16 is bit-equal to JAX's at widths up to 192; at
[256, 1024], where the products' order of sums differs, within 3e-3 at one
draw and 2 % in relative Frobenius norm at four; a copy that multiplies the
Python-float coefficients into bf16 tensors, as a literal translation
would, misses JAX by more than that band. The Muon direction over three updates and
the Trainer's Muon steps (fp32 towers, classifier dropout 0) are held at
5e-3 relative L2.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from evr_tpu.training.muon import muon as j_muon
from evr_tpu.training.muon import muon_param_labels as j_muon_labels
from evr_tpu.training.muon import newton_schulz_orthogonalize as j_ns
from evr_tpu_torch.models.convert import params_from_numpy
from evr_tpu_torch.training import TrainConfig, make_optimizer
from evr_tpu_torch.training.finetune import flat_leaves
from evr_tpu_torch.training.lora import init_lora
from evr_tpu_torch.training.muon import NS_COEFFS, muon_direction, muon_param_labels, newton_schulz_orthogonalize

from torch_trainer_twins import TOL, assert_close_rel, from_flat, jax_steps, np_params, port_steps, tiny_batch, to_np, updates

STEP = dict(optimizer="muon", lr=1e-4, batch_size=8, epochs=2, compute_dtype="float32", freeze_layers=8)


def _ns_literal(g: torch.Tensor, steps: int = 5, eps: float = 1e-7) -> torch.Tensor:
    """Newton–Schulz with the Python-float coefficients multiplied straight
    into the bf16 tensors (the scalars stay at full precision)."""
    a, b, c = NS_COEFFS
    x = g.to(torch.bfloat16)
    x = x / (torch.linalg.vector_norm(x.float()) + eps).to(torch.bfloat16)
    t = g.shape[0] > g.shape[1]
    x = x.T if t else x
    for _ in range(steps):
        xxt = x @ x.T
        x = a * x + (b * xxt + c * (xxt @ xxt)) @ x
    return (x.T if t else x).float()


@pytest.mark.parametrize("shape", [(64, 192), (192, 64), (64, 64)])
def test_newton_schulz_bit_equal_to_jax(shape):
    g = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    g[0] *= 50.0  # badly conditioned, as JAX's own test
    got = newton_schulz_orthogonalize(torch.from_numpy(g)).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_ns(jnp.asarray(g))))
    assert float((got * g).sum()) > 0  # the input's row and column space kept


def test_newton_schulz_wide_case_and_the_unrounded_control():
    """At [256, 1024] the bf16 products sum in another order than XLA's and
    five iterations carry the difference: within 3e-3 at one draw (seed 0),
    about 1 % in relative Frobenius norm at each of four (band 2 %); the
    literal copy misses that band at each draw and at [64, 192]."""
    for seed in range(4):
        g = np.random.default_rng(seed).standard_normal((256, 1024)).astype(np.float32)
        ref = np.asarray(j_ns(jnp.asarray(g)))
        got = newton_schulz_orthogonalize(torch.from_numpy(g)).numpy()
        if seed == 0:
            assert np.abs(got - ref).max() <= 3e-3
        assert np.linalg.norm(got - ref) / np.linalg.norm(ref) <= 0.02, seed
        lit = _ns_literal(torch.from_numpy(g)).numpy()
        assert np.linalg.norm(lit - ref) / np.linalg.norm(ref) > 0.02, seed
    gs = np.random.default_rng(5).standard_normal((64, 192)).astype(np.float32)
    ref_s = np.asarray(j_ns(jnp.asarray(gs)))
    lit = _ns_literal(torch.from_numpy(gs)).numpy()
    assert np.linalg.norm(lit - ref_s) / np.linalg.norm(ref_s) > 0.02 and (lit != ref_s).mean() > 0.5


def test_non_2d_leaves_are_refused():
    with pytest.raises(ValueError, match="2-D"):
        newton_schulz_orthogonalize(torch.ones(3, 3, 3))
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer(TrainConfig(optimizer="sgdqq"), params_from_numpy(np_params()))


def test_param_labels_match_jax_lora_factors_included():
    params = np_params()
    params["lora"] = jax.tree.map(lambda t: t.numpy(), init_lora(0, params["clip"], 4))
    got = flat_leaves(muon_param_labels(params_from_numpy(params)))
    want = flat_leaves(j_muon_labels(jax.tree.map(jnp.asarray, params)))
    assert got == {k: want[k] for k in got}
    assert all(got[k] == "muon" for k in got if k.startswith("lora/"))
    assert got["clip/visual/proj"] == got["clip/text/token_embedding"] == "adamw"
    assert got["clip/visual/blocks/0/mlp/fc/kernel"] == "muon"
    assert got["clip/visual/blocks/0/mlp/fc/bias"] == "adamw"


def test_muon_direction_matches_optax():
    """Three updates of ``muon(lr, momentum 0.9)`` on a wide and a tall
    matrix: ``-lr`` times the port's ``muon_direction``, its momentum buffer
    carried, against optax's updates and buffers."""
    rng = np.random.default_rng(3)
    shapes = {"a": (48, 16), "b": (16, 48)}
    opt = j_muon(learning_rate=0.05, momentum=0.9)
    jstate = opt.init({k: jnp.zeros(v) for k, v in shapes.items()})
    bufs = {k: torch.zeros(v) for k, v in shapes.items()}
    for _ in range(3):
        g = {k: rng.standard_normal(v).astype(np.float32) for k, v in shapes.items()}
        upd, jstate = opt.update(jax.tree.map(jnp.asarray, g), jstate)
        for k in shapes:
            u, bufs[k] = muon_direction(torch.from_numpy(g[k]), bufs[k], momentum=0.9)
            np.testing.assert_allclose((-0.05 * u).numpy(), np.asarray(upd[k]), rtol=1e-6, atol=1e-8, err_msg=k)
            np.testing.assert_array_equal(bufs[k].numpy(), np.asarray(jstate[0].momentum[k]))


def test_muon_optimizer_steps_match_optax_from_the_same_gradients():
    """The Trainer's Muon optimizer (``make_optimizer``, clip on, freeze 8)
    against the JAX package's on the same gradients, two steps (Muon's
    momentum and AdamW's moments carried into the second). AdamW leaves'
    updates within 5e-3. A Muon leaf's update is Newton–Schulz of a bf16
    cast of ``g + μ·buf``, which XLA may contract into one rounding where
    the port rounds twice: last-bit differences that flip a few bf16
    roundings, carried to about 1 % of the update by five iterations, so
    those leaves are held by cosine 0.999 (Newton–Schulz itself is
    bit-equal on equal inputs, above). The gradients' norm stays under the
    clip's threshold, whose order of sums would add its own last bits."""
    from evr_tpu.training import TrainConfig as JTrainConfig
    from evr_tpu.training import make_optimizer as j_make_optimizer

    params = np_params()
    tp = params_from_numpy(params)
    topt = make_optimizer(TrainConfig(**STEP), tp)
    tstate = topt.init(tp)
    jp = jax.tree.map(jnp.asarray, params)
    jopt = j_make_optimizer(JTrainConfig(**STEP), jp)
    jstate = jopt.init(jp)
    muon_keys = [k for k, lab in topt.labels.items() if lab.endswith(":muon")]
    adam_keys = [k for k, lab in topt.labels.items() if lab != "frozen" and k not in muon_keys]
    rng = np.random.default_rng(6)
    for s in range(2):
        before = to_np(tp)
        g = {k: (rng.standard_normal(v.shape) * 1e-3).astype(np.float32) if topt.labels[k] != "frozen"
             else np.zeros(v.shape, np.float32) for k, v in before.items()}
        assert np.sqrt(sum((v.astype(np.float64) ** 2).sum() for v in g.values())) < 1.0
        upd, jstate = jopt.update(from_flat(params, {k: jnp.asarray(v) for k, v in g.items()}), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        topt.apply(tp, {k: torch.as_tensor(v) for k, v in g.items() if topt.labels[k] != "frozen"}, tstate)
        ut, uj = updates(to_np(tp), before), updates(to_np(jp), before)
        assert assert_close_rel(ut, uj, TOL, f"step {s}", keys=adam_keys) == len(adam_keys)
        for k in muon_keys:
            cos = float((ut[k] * uj[k]).sum() / (np.linalg.norm(ut[k]) * np.linalg.norm(uj[k])))
            assert cos >= 0.999, (s, k, cos)
    assert set(tstate["momentum"]) == set(muon_keys)


@pytest.fixture(scope="module")
def muon_steps():
    params = np_params()
    rng = np.random.default_rng(4)
    batches = [tiny_batch(rng) for _ in range(2)]
    return params, jax_steps(STEP, params, batches), port_steps(STEP, params, batches)


def test_muon_trainer_steps_match_jax(muon_steps):
    """Two Trainer steps end to end. The losses, gradient norms and AdamW
    leaves' updates hold at 5e-3 and below. A Muon leaf's update is
    Newton–Schulz of a bf16 cast: the gradients' fp32 differences (about
    1e-6 relative) flip the roundings of a few in ten thousand elements,
    and five iterations carry those flips to about 2 % of the update, so
    the Muon leaves are held by cosine: 0.999 (about 4.5 % relative) in the
    first step, 0.99 in the second, which starts from params the first moved
    apart and carries the momentum. The optimizer on equal gradients is
    held at 5e-3 above."""
    params, (jm, jafter, _), (tm, tafter, tstate) = muon_steps
    before = to_np(params)
    labels = make_optimizer(TrainConfig(**STEP), params_from_numpy(params)).labels
    muon_keys = [k for k, lab in labels.items() if lab.endswith(":muon")]
    adam_keys = [k for k, lab in labels.items() if lab != "frozen" and k not in muon_keys]
    for s in range(2):
        # the second step starts from params the first step's Muon leaves moved apart
        np.testing.assert_allclose(tm[s]["total_loss"], jm[s]["total_loss"], rtol=1e-5 if s == 0 else TOL)
        np.testing.assert_allclose(tm[s]["grad_norm"], jm[s]["grad_norm"], rtol=1e-4 if s == 0 else TOL)
        prev_t, prev_j = (before, before) if s == 0 else (tafter[s - 1], jafter[s - 1])
        ut, uj = updates(tafter[s], prev_t), updates(jafter[s], prev_j)
        assert_close_rel(ut, uj, TOL, f"step {s}", keys=adam_keys)
        for k in muon_keys:
            cos = float((ut[k] * uj[k]).sum() / (np.linalg.norm(ut[k]) * np.linalg.norm(uj[k])))
            assert cos >= (0.999 if s == 0 else 0.99), (s, k, cos)
    inner = tstate.opt_state
    assert set(inner["momentum"]) == set(muon_keys) and not set(muon_keys) & set(inner["mu"])
    # two towers x two blocks x four kernels, less those freeze_layers=8 holds:
    # the first visual qkv and the first text qkv, out and fc
    assert len(muon_keys) == 16 - 4
