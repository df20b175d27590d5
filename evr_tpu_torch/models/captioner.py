"""The prefix captioner behind SCST (PyTorch).

Counterpart of ``evr_tpu/models/captioner.py``: a ClipCap-style captioner.
A CLIP image embedding is mapped to ``prefix_len`` soft tokens by a
two-layer MLP, and a small causal transformer over the CLIP BPE vocabulary
generates the caption, its output head tied to the token embedding. Sharing
CLIP's vocabulary lets a generated buffer feed the CLIP text tower directly
for the reward (``training.scst``).

Decoding follows the JAX package: greedy or sampled (top-k, then top-p, then
a categorical draw), ``max_new_tokens`` steps, SOT never re-emitted, ids
after EOT padded with 0 and marked invalid, EOT forced into the last slot of
a rollout that never emitted it. ``use_cache=True`` prefills the prefix once
and runs each step's blocks on the one new row
(``layers.block_apply_cached``); ``use_cache=False`` re-runs the whole
buffer every step, the reference the cache is held to. Where the JAX package
scans a fixed number of steps, the port's loop stops once every row has
emitted EOT (the remaining slots are the scan's zeros). The blocks run the
plain composition (``block_apply`` with its default ``attn_impl``), on the
card as on the CPU, as in the JAX package; there is no kernel here.

Random weights and samples come from explicit ``torch.Generator``s (the JAX
package's streams cannot be reproduced; tests carry its params and its
sampled tokens across).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from .layers import block_apply, block_apply_cached, layer_norm, linear, quick_gelu

Params = dict[str, Any]


@dataclass(frozen=True)
class CaptionerConfig:
    # CLIP BPE vocabulary; SOT/EOT are the last ids
    vocab_size: int = 49408
    sot_id: int = 49406
    eot_id: int = 49407
    # the decoder
    width: int = 512
    layers: int = 4
    heads: int = 8
    # image embedding → prefix_len soft tokens
    image_dim: int = 512
    prefix_len: int = 10
    max_new_tokens: int = 30

    @property
    def buf_len(self) -> int:
        """Token buffer length: SOT + generated tokens."""
        return 1 + self.max_new_tokens

    @property
    def seq_len(self) -> int:
        return self.prefix_len + self.buf_len


def init_captioner_params(generator: torch.Generator | int, cfg: CaptionerConfig) -> Params:
    """Random captioner weights (fp32, CPU) at the JAX package's scales,
    drawn from ``generator`` (or a generator seeded with it)."""
    gen = generator if isinstance(generator, torch.Generator) else torch.Generator().manual_seed(int(generator))

    def normal(shape, std):
        return torch.randn(shape, generator=gen, dtype=torch.float32) * std

    def lin(d_in, d_out, std=None):
        return {"kernel": normal((d_in, d_out), d_in ** -0.5 if std is None else std),
                "bias": torch.zeros(d_out)}

    W, L = cfg.width, cfg.layers
    proj_std = (W ** -0.5) * ((2 * L) ** -0.5)

    def block():
        return {
            "ln_1": {"scale": torch.ones(W), "bias": torch.zeros(W)},
            "attn": {"qkv": lin(W, 3 * W, W ** -0.5), "out": lin(W, W, proj_std)},
            "ln_2": {"scale": torch.ones(W), "bias": torch.zeros(W)},
            "mlp": {"fc": lin(W, 4 * W, (2 * W) ** -0.5), "proj": lin(4 * W, W, proj_std)},
        }

    return {
        "mapper": {"fc": lin(cfg.image_dim, W * cfg.prefix_len),
                   "proj": lin(W * cfg.prefix_len, W * cfg.prefix_len)},
        "token_embedding": normal((cfg.vocab_size, W), 0.02),
        "pos_embedding": normal((cfg.seq_len, W), 0.01),
        "blocks": [block() for _ in range(L)],
        "ln_final": {"scale": torch.ones(W), "bias": torch.zeros(W)},
    }


def image_prefix(params: Params, cfg: CaptionerConfig, image_emb: torch.Tensor) -> torch.Tensor:
    """[B, image_dim] → [B, prefix_len, width] soft tokens."""
    h = quick_gelu(linear(image_emb, params["mapper"]["fc"]))
    h = linear(h, params["mapper"]["proj"])
    return h.reshape(image_emb.shape[0], cfg.prefix_len, cfg.width)


def caption_logits(params: Params, cfg: CaptionerConfig, image_emb: torch.Tensor, tokens: torch.Tensor,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Teacher-forced pass: tokens [B, L] (SOT first) → fp32 logits [B, L,
    vocab]; logits[:, i] predicts tokens[:, i + 1]."""
    prefix = image_prefix(params, cfg, image_emb).to(dtype)
    tok = params["token_embedding"].to(dtype)[tokens.long()]
    x = torch.cat([prefix, tok], dim=1) + params["pos_embedding"].to(dtype)
    for blk in params["blocks"]:
        x = block_apply(x, blk, cfg.heads, causal=True)
    x = layer_norm(x, params["ln_final"])
    return (x[:, cfg.prefix_len:] @ params["token_embedding"].to(dtype).T).float()


def token_logprobs(params: Params, cfg: CaptionerConfig, image_emb: torch.Tensor, tokens: torch.Tensor,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Teacher-forced log p(tokens[:, i]) for i ≥ 1 → [B, L − 1]."""
    logp = torch.log_softmax(caption_logits(params, cfg, image_emb, tokens, dtype)[:, :-1], dim=-1)
    return torch.gather(logp, -1, tokens[:, 1:, None].long())[..., 0]


def sequence_logprob(params: Params, cfg: CaptionerConfig, image_emb: torch.Tensor, tokens: torch.Tensor,
                     valid: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Σ log p(tokens[:, 1:]) over the valid generated positions → [B]."""
    picked = token_logprobs(params, cfg, image_emb, tokens, dtype)
    return (picked * valid[:, 1:].float()).sum(dim=-1)


def filter_logits(logits: torch.Tensor, top_k: int, top_p: float, temperature: float) -> torch.Tensor:
    """The sampling filter of the JAX package's ``_sample_filtered``: logits
    over the temperature, −inf below the k-th largest, then −inf below the
    smallest logit whose exclusive cumulative probability (in descending
    order) is ≤ ``top_p``."""
    logits = logits / max(temperature, 1e-6)
    neg = torch.tensor(-float("inf"), device=logits.device)
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, neg, logits)
    if 0.0 < top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1) - probs  # exclusive
        cutoff = torch.where(cum <= top_p, sorted_logits, torch.tensor(float("inf"), device=logits.device))
        logits = torch.where(logits < cutoff.amin(dim=-1, keepdim=True), neg, logits)
    return logits


def _sample_filtered(generator: torch.Generator, logits: torch.Tensor, top_k: int, top_p: float,
                     temperature: float) -> torch.Tensor:
    """One draw per row from the filtered distribution (Gumbel-max over
    ``filter_logits``, the form ``jax.random.categorical`` takes)."""
    logits = filter_logits(logits, top_k, top_p, temperature)
    u = torch.rand(logits.shape, generator=generator, device=logits.device).clamp_min(torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def _prefill(params: Params, cfg: CaptionerConfig, image_emb: torch.Tensor, dtype) -> list:
    """The prefix through every block: each block's (k_cache, v_cache) [B,
    seq_len, heads, head_dim], rows 0 .. prefix_len − 1 filled."""
    B, H = image_emb.shape[0], cfg.heads
    x = image_prefix(params, cfg, image_emb).to(dtype) + params["pos_embedding"].to(dtype)[: cfg.prefix_len]
    caches = []
    for blk in params["blocks"]:
        kc = torch.zeros((B, cfg.seq_len, H, cfg.width // H), dtype=dtype, device=image_emb.device)
        x, kc, vc = block_apply_cached(x, blk, H, kc, torch.zeros_like(kc), 0)
        caches.append((kc, vc))
    return caches


def _step_logits(params: Params, cfg: CaptionerConfig, tok: torch.Tensor, i: int, caches: list, dtype):
    """One cached decode step: the ids at buffer position i → fp32 logits of
    the next id, and the updated caches."""
    p_abs = cfg.prefix_len + i
    emb = params["token_embedding"].to(dtype)
    x = emb[tok][:, None, :] + params["pos_embedding"].to(dtype)[p_abs:p_abs + 1]
    new = []
    for blk, (kc, vc) in zip(params["blocks"], caches):
        x, kc, vc = block_apply_cached(x, blk, cfg.heads, kc, vc, p_abs)
        new.append((kc, vc))
    h = layer_norm(x, params["ln_final"])[:, 0]
    return (h @ emb.T).float(), new


@torch.no_grad()
def generate(
    params: Params,
    cfg: CaptionerConfig,
    image_emb: torch.Tensor,
    generator: torch.Generator | None = None,
    sample: bool = False,
    temperature: float = 1.0,
    top_k: int = 50,
    top_p: float = 0.9,
    dtype: torch.dtype = torch.float32,
    use_cache: bool = True,
    step_logits: list | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Captions for a batch of image embeddings → (tokens [B, buf_len] int64,
    valid [B, buf_len] bool): SOT first; EOT included and valid; 0 after it;
    EOT forced into the last slot of a row that never emitted it.
    ``sample`` draws from ``generator`` (top-k, top-p, temperature), else
    greedy (the first maximum). ``step_logits``: a list each step's logits
    (after the SOT ban) are appended to, for checks of near ties."""
    B = image_emb.shape[0]
    dev = image_emb.device
    if sample and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    buf = torch.zeros((B, cfg.buf_len), dtype=torch.long, device=dev)
    buf[:, 0] = cfg.sot_id
    valid = torch.zeros((B, cfg.buf_len), dtype=torch.bool, device=dev)
    valid[:, 0] = True
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    caches = _prefill(params, cfg, image_emb, dtype) if use_cache else None
    for i in range(cfg.max_new_tokens):
        if use_cache:
            cur, caches = _step_logits(params, cfg, buf[:, i], i, caches, dtype)
        else:
            cur = caption_logits(params, cfg, image_emb, buf, dtype)[:, i]
        cur[:, cfg.sot_id] = -float("inf")  # never re-emit SOT
        if step_logits is not None:
            step_logits.append(cur)
        nxt = (_sample_filtered(generator, cur, top_k, top_p, temperature) if sample
               else torch.argmax(cur, dim=-1))
        buf[:, i + 1] = torch.where(done, torch.zeros_like(nxt), nxt)
        valid[:, i + 1] = ~done
        done = done | (nxt == cfg.eot_id)
        if bool(done.all()):
            break
    buf[:, -1] = torch.where(done, buf[:, -1], torch.full_like(buf[:, -1], cfg.eot_id))
    return buf, valid


@torch.no_grad()
def beam_search(
    params: Params,
    cfg: CaptionerConfig,
    image_emb: torch.Tensor,
    beam_size: int = 4,
    length_penalty: float = 0.0,
    dtype: torch.dtype = torch.float32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Beam-search decoding with the KV caches, as the JAX package's: each
    step every live beam proposes its full-vocabulary log-probabilities
    (SOT banned at selection), a finished beam one frozen candidate on id 0;
    the top ``beam_size`` of the joint candidates survive (ties to the lower
    index) and the caches are re-gathered to their parents; a register keeps
    the best hypothesis finished at each step. Returns (tokens [B, buf_len],
    score [B]): the summed token log-probability, over ``length **
    length_penalty`` when ``length_penalty`` > 0. ``beam_size=1`` is greedy
    ``generate``."""
    B, K, V = image_emb.shape[0], beam_size, cfg.vocab_size
    dev = image_emb.device
    NEG = torch.tensor(-1e9, device=dev)
    ninf = torch.tensor(-float("inf"), device=dev)
    caches = [tuple(torch.repeat_interleave(c, K, dim=0) for c in kv)
              for kv in _prefill(params, cfg, image_emb, dtype)]
    buf = torch.zeros((B, K, cfg.buf_len), dtype=torch.long, device=dev)
    buf[:, :, 0] = cfg.sot_id
    logp = torch.full((B, K), -float("inf"), device=dev)
    logp[:, 0] = 0.0
    done = torch.zeros((B, K), dtype=torch.bool, device=dev)
    lens = torch.zeros((B, K), dtype=torch.long, device=dev)
    fin_score = torch.full((B,), -float("inf"), device=dev)
    fin_toks = torch.zeros((B, cfg.buf_len), dtype=torch.long, device=dev)
    rows = torch.arange(B, device=dev)

    def penalise(raw, length):
        if length_penalty > 0.0:
            return raw / length.clamp_min(1).float() ** length_penalty
        return raw

    for i in range(cfg.max_new_tokens):
        logits, caches = _step_logits(params, cfg, buf[:, :, i].reshape(B * K), i, caches, dtype)
        step_logp = torch.log_softmax(logits.reshape(B, K, V), dim=-1)
        step_logp[:, :, cfg.sot_id] = -float("inf")
        cand = torch.where(done[:, :, None], NEG, logp[:, :, None] + step_logp)
        cand[:, :, 0] = torch.maximum(cand[:, :, 0], torch.where(done, logp, NEG))
        top_scores, top_idx = torch.sort(cand.reshape(B, K * V), dim=-1, descending=True, stable=True)
        top_scores, top_idx = top_scores[:, :K], top_idx[:, :K]
        parent, token = top_idx // V, top_idx % V
        parent_done = torch.gather(done, 1, parent)
        token = torch.where(parent_done, torch.zeros_like(token), token)
        new_done = parent_done | (token == cfg.eot_id)
        lens = torch.gather(lens, 1, parent) + (~parent_done).long()
        buf = torch.gather(buf, 1, parent[:, :, None].expand(-1, -1, cfg.buf_len)).clone()
        buf[:, :, i + 1] = token
        gather = (rows[:, None] * K + parent).reshape(B * K)
        caches = [(kc[gather], vc[gather]) for kc, vc in caches]
        newly = new_done & ~parent_done
        cand_fin = torch.where(newly, penalise(top_scores, lens), ninf)
        k_best = torch.argmax(cand_fin, dim=1)
        v_best = cand_fin[rows, k_best]
        improve = v_best > fin_score
        fin_score = torch.where(improve, v_best, fin_score)
        fin_toks = torch.where(improve[:, None], buf[rows, k_best], fin_toks)
        logp, done = top_scores, new_done
    buf[:, :, -1] = torch.where(done, buf[:, :, -1], torch.full_like(buf[:, :, -1], cfg.eot_id))
    lens = torch.where(done, lens, lens + 1)
    score = penalise(logp, lens)
    best = torch.argmax(score, dim=1)
    tokens, best_score = buf[rows, best], score[rows, best]
    from_reg = fin_score > best_score
    return torch.where(from_reg[:, None], fin_toks, tokens), torch.where(from_reg, fin_score, best_score)


def tokens_to_context(tokens: torch.Tensor, context_length: int = 77, eot_id: int | None = None) -> torch.Tensor:
    """A buffer [B, buf_len] padded (or truncated) to CLIP's [B,
    context_length]; a truncated row's last position forced to EOT."""
    B, L = tokens.shape
    if L >= context_length:
        out = tokens[:, :context_length].clone()
        if L > context_length and eot_id is not None:
            out[:, -1] = eot_id
        return out
    return torch.cat([tokens, torch.zeros((B, context_length - L), dtype=tokens.dtype, device=tokens.device)],
                     dim=1)


def decode_tokens(tokenizer, tokens, eot_id: int) -> list[str]:
    """Buffers [B, buf_len] → text: SOT dropped, each row cut at its first
    EOT (id 0 is a real BPE token, '!', and padding only follows the EOT)."""
    out = []
    for row in np.asarray(tokens.cpu() if isinstance(tokens, torch.Tensor) else tokens):
        body = row[1:]
        hits = np.nonzero(body == eot_id)[0]
        end = int(hits[0]) if hits.size else len(body)
        out.append(tokenizer.decode([int(t) for t in body[:end]]).strip())
    return out
