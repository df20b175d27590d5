"""The port's prefix captioner (``evr_tpu_torch.models.captioner``) and
``layers.block_apply_cached`` against ``evr_tpu`` on the CPU.

The JAX package draws the params; they are carried across with the token
embedding ×10, which spreads the logits so that every greedy step's top-2
gap is far above the packages' fp32 differences (asserted: random weights
otherwise decode near ties). Tolerances: 1e-5 (block outputs, caches,
log-probabilities, beam scores); ids equal (greedy, cached against a full
re-run, beam search, top-k 1 sampling).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from evr_tpu.models import captioner as jc
from evr_tpu.models import layers as jl
from evr_tpu.tokenizer import get_default_tokenizer as j_tokenizer
from evr_tpu_torch.models import captioner as tc
from evr_tpu_torch.models import layers as tl
from evr_tpu_torch.models.convert import params_from_numpy
from evr_tpu_torch.tokenizer import get_default_tokenizer as t_tokenizer

from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5
J_CFG = jc.CaptionerConfig(vocab_size=512, sot_id=510, eot_id=511, width=64, layers=2, heads=4, image_dim=32,
                           prefix_len=4, max_new_tokens=12)
T_CFG = tc.CaptionerConfig(**dataclasses.asdict(J_CFG))
MIN_GAP = 1e-2  # the least top-2 gap a held greedy step may have


def spread(params: dict) -> dict:
    return {**params, "token_embedding": params["token_embedding"] * 10}


@pytest.fixture(scope="module")
def twins():
    jp = jax.tree.map(np.asarray, spread(jc.init_captioner_params(jax.random.PRNGKey(0), J_CFG)))
    emb = np.random.default_rng(0).normal(size=(4, 32)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    return jp, params_from_numpy(jp), emb


@pytest.fixture(scope="module")
def greedy(twins):
    jp, tp, emb = twins
    jt, jv = jax.jit(lambda p, e: jc.generate(p, J_CFG, e))(jp, emb)
    steps: list = []
    tt, tv = tc.generate(tp, T_CFG, torch.from_numpy(emb), step_logits=steps)
    return np.asarray(jt), np.asarray(jv), tt, tv, steps


def least_gap(steps) -> float:
    return min(float((s.topk(2).values[:, 0] - s.topk(2).values[:, 1]).min()) for s in steps)


def test_block_apply_cached_matches_jax():
    """Prefill rows 0..4, one new row at 5, then two rows rewritten at 3..4:
    outputs and caches against JAX's, and each row against the full causal
    block over the rows so far."""
    bp = jax.tree.map(np.asarray, jl.init_block(jax.random.PRNGKey(1), 32, 2))
    tb = params_from_numpy(bp)
    x = np.random.default_rng(1).normal(size=(2, 6, 32)).astype(np.float32)
    kj = vj = jnp.zeros((2, 8, 4, 8))
    kt = vt = torch.zeros((2, 8, 4, 8))
    for lo, hi in ((0, 5), (5, 6), (3, 5)):
        yj, kj, vj = jl.block_apply_cached(jnp.asarray(x[:, lo:hi]), bp, 4, kj, vj, lo)
        yt, kt, vt = tl.block_apply_cached(torch.from_numpy(x[:, lo:hi]), tb, 4, kt, vt, lo)
        for got, ref in ((yt, yj), (kt, kj), (vt, vj)):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=TOL)
        full = tl.block_apply(torch.from_numpy(x[:, :hi]), tb, 4, causal=True)
        np.testing.assert_allclose(yt.numpy(), full[:, lo:hi].numpy(), rtol=0, atol=TOL)
    assert not kt[:, 6:].any()  # rows past the written ones stay as given


def test_greedy_ids_and_logprobs_match_jax(twins, greedy):
    jp, tp, emb = twins
    jt, jv, tt, tv, steps = greedy
    np.testing.assert_array_equal(tt.numpy(), jt)
    np.testing.assert_array_equal(tv.numpy(), jv)
    assert least_gap(steps) > MIN_GAP
    lj = jc.sequence_logprob(jp, J_CFG, jnp.asarray(emb), jnp.asarray(jt), jnp.asarray(jv))
    lt = tc.sequence_logprob(tp, T_CFG, torch.from_numpy(emb), tt, tv)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=TOL)
    assert (tt[:, 0] == T_CFG.sot_id).all() and (tt[:, -1] == T_CFG.eot_id).all()  # forced EOT


def test_cached_decode_equals_a_full_rerun(twins, greedy, monkeypatch):
    """``use_cache=False`` re-runs the whole buffer every step: the same ids,
    step logits within 1e-5; a cache whose prefix rows are zeroed (the
    control) moves the logits far past that."""
    _, tp, emb = twins
    _, _, tt, _, steps = greedy
    full_steps: list = []
    ft, _ = tc.generate(tp, T_CFG, torch.from_numpy(emb), use_cache=False, step_logits=full_steps)
    np.testing.assert_array_equal(ft.numpy(), tt.numpy())
    assert len(full_steps) == len(steps)
    for a, b in zip(steps, full_steps):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=TOL)
    real = tl.block_apply_cached

    def zeroed(x, p, h, kc, vc, pos, activation="quick_gelu"):
        y, kc, vc = real(x, p, h, kc, vc, pos, activation)
        if pos > 0:
            kc, vc = kc.clone(), vc.clone()
            kc[:, 0] = 0
            vc[:, 0] = 0
        return y, kc, vc

    monkeypatch.setattr(tc, "block_apply_cached", zeroed)
    bad: list = []
    tc.generate(tp, T_CFG, torch.from_numpy(emb), step_logits=bad)
    finite = torch.isfinite(full_steps[0])  # the banned SOT column is -inf in both
    assert max(float((a - b)[finite].abs().max()) for a, b in zip(bad, full_steps)) > 1e-2


@pytest.mark.parametrize("beam, penalty", [(3, 0.0), (4, 0.7)])
def test_beam_search_matches_jax(twins, beam, penalty):
    jp, tp, emb = twins
    jt, js = jax.jit(lambda p, e: jc.beam_search(p, J_CFG, e, beam_size=beam, length_penalty=penalty))(jp, emb)
    tt, ts = tc.beam_search(tp, T_CFG, torch.from_numpy(emb), beam_size=beam, length_penalty=penalty)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=TOL)


def test_beam_one_is_greedy_and_scores_its_logprob(twins, greedy):
    _, tp, emb = twins
    _, _, tt, tv, _ = greedy
    bt, bs = tc.beam_search(tp, T_CFG, torch.from_numpy(emb), beam_size=1)
    np.testing.assert_array_equal(bt.numpy(), tt.numpy())
    # without a forced EOT the beam's score is the buffer's teacher-forced logprob
    natural = (tt == T_CFG.eot_id)[:, 1:-1].any(dim=1)
    lp = tc.sequence_logprob(tp, T_CFG, torch.from_numpy(emb), tt, tv)
    np.testing.assert_allclose(bs[natural].numpy(), lp[natural].numpy(), rtol=0, atol=1e-4)


def test_teacher_forced_logprobs_match_jax(twins):
    jp, tp, emb = twins
    rng = np.random.default_rng(2)
    toks = rng.integers(0, 509, size=(4, T_CFG.buf_len)).astype(np.int32)
    toks[:, 0] = T_CFG.sot_id
    lj = jc.token_logprobs(jp, J_CFG, jnp.asarray(emb), jnp.asarray(toks))
    lt = tc.token_logprobs(tp, T_CFG, torch.from_numpy(emb), torch.from_numpy(toks))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0, atol=TOL)
    cj = jc.caption_logits(jp, J_CFG, jnp.asarray(emb), jnp.asarray(toks))
    ct = tc.caption_logits(tp, T_CFG, torch.from_numpy(emb), torch.from_numpy(toks))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=0, atol=1e-4)
    assert ct.shape == (4, T_CFG.buf_len, 512) and ct.dtype == torch.float32


def test_tokens_to_context_and_decode_tokens_match_jax():
    rng = np.random.default_rng(3)
    toks = rng.integers(1, 40000, size=(3, 31)).astype(np.int32)
    toks[:, 0] = 49406
    toks[0, 5], toks[0, 6:] = 49407, 0
    toks[1, 12] = 49407  # a row cut at its first EOT, later ids dropped
    for ctx in (77, 31, 16):
        got = tc.tokens_to_context(torch.from_numpy(toks).long(), ctx, eot_id=49407)
        ref = jc.tokens_to_context(jnp.asarray(toks), ctx, eot_id=49407)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert tc.decode_tokens(t_tokenizer(), torch.from_numpy(toks), 49407) == \
        jc.decode_tokens(j_tokenizer(), toks, 49407)


def test_sampling_top_k_one_is_greedy_and_the_filtered_sets(twins, greedy):
    """``top_k=1`` leaves one id a step: the sampled rollout is the greedy
    one. The filter's kept ids equal the definition (the k largest, then
    the smallest descending prefix whose exclusive cumulative probability
    stays ≤ top_p), and JAX's samples fall in them."""
    jp, tp, emb = twins
    _, _, tt, _, _ = greedy
    st, _ = tc.generate(tp, T_CFG, torch.from_numpy(emb), generator=torch.Generator().manual_seed(1), sample=True,
                        top_k=1)
    np.testing.assert_array_equal(st.numpy(), tt.numpy())
    logits = np.random.default_rng(4).normal(size=(3, 512)).astype(np.float32) * 3
    for k, p, temp in ((50, 0.9, 1.0), (0, 0.5, 0.7), (20, 1.0, 1.3)):
        kept = torch.isfinite(tc.filter_logits(torch.from_numpy(logits), k, p, temp)).numpy()
        for row, keep in zip(logits / temp, kept):
            order = np.argsort(-row, kind="stable")
            allowed = order[: k or 512]
            if 0 < p < 1:
                probs = np.exp(row[allowed] - row[allowed].max())
                probs /= probs.sum()
                allowed = allowed[(np.cumsum(probs) - probs) <= p]
            assert set(np.nonzero(keep)[0]) == set(allowed.tolist())
        draws = jax.vmap(lambda key: jc._sample_filtered(key, jnp.asarray(logits), k, p, temp))(
            jax.random.split(jax.random.PRNGKey(0), 64))
        assert all(kept[r, int(t)] for row in np.asarray(draws) for r, t in enumerate(row))
        ours = tc._sample_filtered(torch.Generator().manual_seed(0), torch.from_numpy(logits).repeat(64, 1), k, p,
                                   temp).reshape(64, 3)
        assert all(kept[r, int(t)] for row in ours.numpy() for r, t in enumerate(row))


def test_init_matches_the_jax_tree_and_scales():
    tp = tc.init_captioner_params(torch.Generator().manual_seed(0), T_CFG)
    jp = jc.init_captioner_params(jax.random.PRNGKey(0), J_CFG)
    assert jax.tree.map(lambda a: tuple(np.shape(a)), jax.tree.map(np.asarray, tp)) == \
        jax.tree.map(lambda a: tuple(np.shape(a)), jp)
    assert 0.018 < float(tp["token_embedding"].std()) < 0.022
    assert 0.0095 < float(tp["pos_embedding"].std()) < 0.0105
    w = tp["mapper"]["fc"]["kernel"]
    assert abs(float(w.std()) - 32 ** -0.5) < 0.01 and not tp["mapper"]["fc"]["bias"].any()
