"""Self-critical sequence training (SCST) of the prefix captioner (PyTorch).

Counterpart of ``evr_tpu/training/scst.py``: REINFORCE on a sampled
rollout's teacher-forced log-probabilities with the greedy rollout's reward
as the baseline; the reward is CLIP's cosine between the image features and
the caption's text features, clamped at 0 and ×100; the advantage scaled by
``advantage_scale``; ``clip_by_global_norm`` then AdamW under a finite
guard (optax's ``apply_if_finite(chain(clip, adamw), 10)``, written out);
per-epoch greedy validation with an early stop at ``target_reward``; an XE
(teacher-forced) warm start. The CLIP towers are frozen: the text tower
runs the reward (K1/K2 on the card under CLIP's default route), the image
features are computed once per dataset by the caller.

Rollouts and the reward run in fp32, as the JAX step does; samples come
from a ``torch.Generator``. Checkpoints are torch files,
``<save_dir>/<name>.pt`` holding ``{"params": tree}``, where the JAX
trainer writes orbax directories.
"""

from __future__ import annotations

import pathlib
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from evr_tpu_torch.models.captioner import (
    CaptionerConfig,
    generate,
    init_captioner_params,
    sequence_logprob,
    token_logprobs,
    tokens_to_context,
)
from evr_tpu_torch.models.clip import CLIPConfig, encode_text
from evr_tpu_torch.models.convert import params_from_numpy
from evr_tpu_torch.utils.device import resolve_device

from .finetune import clip_by_global_norm, flat_leaves
from .partition import map_with_paths
from .variants import AdamW

Params = dict[str, Any]


@dataclass(frozen=True)
class ScstConfig:
    lr: float = 3e-5
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    # the reference scales its reward difference by 0.01
    advantage_scale: float = 0.01
    target_reward: float = 40.0
    # the reference generate call's sampling
    temperature: float = 1.0
    top_k: int = 50
    top_p: float = 0.9
    batch_size: int = 32
    save_dir: str = "checkpoints_scst"


def clip_text_reward(clip_params: Params, clip_cfg: CLIPConfig, image_features: torch.Tensor,
                     tokens: torch.Tensor, dtype: torch.dtype = torch.float32,
                     eot_id: int | None = None) -> torch.Tensor:
    """100 · max(0, cos(image, caption)) → [B]. ``image_features``: unit
    rows; ``tokens``: caption buffers, padded (or truncated, EOT last) to
    the text context."""
    ctx = tokens_to_context(tokens, clip_cfg.text.context_length, eot_id=eot_id)
    txt = encode_text(clip_params, clip_cfg, ctx, dtype)
    txt = txt / txt.norm(dim=-1, keepdim=True).clamp_min(1e-8)
    return (image_features * txt).sum(dim=-1).clamp_min(0.0) * 100.0


def xe_caption_loss(params: Params, cfg: CaptionerConfig, image_emb: torch.Tensor, tokens: torch.Tensor,
                    valid: torch.Tensor) -> torch.Tensor:
    """The teacher-forced cross-entropy warm start: the mean negative
    log-probability over the valid generated positions."""
    picked = token_logprobs(params, cfg, image_emb, tokens)
    mask = valid[:, 1:].float()
    return -(picked * mask).sum() / mask.sum().clamp_min(1.0)


class ScstOptimizer:
    """``optax.apply_if_finite(chain(clip_by_global_norm(grad_clip),
    adamw(lr, weight_decay=wd)), max_consecutive_errors)`` over every leaf
    of a params tree: a non-finite gradient skips the update (the AdamW
    state unchanged) unless more than ``max_consecutive_errors`` in a row
    were skipped."""

    def __init__(self, cfg: ScstConfig, max_consecutive_errors: int = 10):
        self.grad_clip = cfg.grad_clip
        self.adamw = AdamW(cfg.lr, weight_decay=cfg.weight_decay)
        self.max_errors = max_consecutive_errors

    def init(self, params) -> dict:
        return {"inner": self.adamw.init(flat_leaves(params)), "notfinite_count": 0}

    @torch.no_grad()
    def apply(self, params, grads: dict[str, torch.Tensor], state: dict) -> bool:
        """Update ``params`` in place; whether the update was applied."""
        finite = bool(torch.stack([torch.isfinite(g).all() for g in grads.values()]).all())
        state["notfinite_count"] = 0 if finite else state["notfinite_count"] + 1
        if not (finite or state["notfinite_count"] > self.max_errors):
            return False
        if self.grad_clip > 0:
            grads = clip_by_global_norm(grads, self.grad_clip)
        self.adamw.apply(flat_leaves(params), grads, state["inner"])
        return True


def value_and_grads(loss_fn: Callable, params: Params) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """(loss, path key → gradient of every leaf) of ``loss_fn(params)``,
    through detached aliases of the leaves."""
    aliases = map_with_paths(params, lambda _, t: t.detach().requires_grad_(True))
    with torch.enable_grad():
        loss = loss_fn(aliases)
        leaves = flat_leaves(aliases)
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return loss.detach(), {k: torch.zeros_like(t) if g is None else g
                           for (k, t), g in zip(leaves.items(), grads)}


def make_scst_step(cap_cfg: CaptionerConfig, clip_cfg: CLIPConfig, cfg: ScstConfig,
                   optimizer: ScstOptimizer) -> Callable:
    """``step(params, opt_state, clip_params, image_features, generator,
    sampled=None) -> metrics``: the greedy rollout, the sampled rollout
    (``generator``'s draws, or ``sampled`` = (tokens, valid) handed in),
    both rewards, the policy gradient of −mean(advantage · log p(sampled))
    and one optimizer update of ``params`` in place. ``image_features``:
    [B, D] unit rows on the params' device."""

    def step(params, opt_state, clip_params, image_features, generator=None, sampled=None):
        greedy_toks, _ = generate(params, cap_cfg, image_features, sample=False)
        if sampled is None:
            sampled = generate(params, cap_cfg, image_features, generator=generator, sample=True,
                               temperature=cfg.temperature, top_k=cfg.top_k, top_p=cfg.top_p)
        sampled_toks, sampled_valid = (torch.as_tensor(t, device=image_features.device) for t in sampled)
        with torch.no_grad():
            r_greedy = clip_text_reward(clip_params, clip_cfg, image_features, greedy_toks, eot_id=cap_cfg.eot_id)
            r_sample = clip_text_reward(clip_params, clip_cfg, image_features, sampled_toks,
                                        eot_id=cap_cfg.eot_id)
        advantage = (r_sample - r_greedy) * cfg.advantage_scale
        loss, grads = value_and_grads(
            lambda p: -(advantage * sequence_logprob(p, cap_cfg, image_features, sampled_toks,
                                                     sampled_valid)).mean(), params)
        optimizer.apply(params, grads, opt_state)
        return {"loss": loss, "reward_sample": r_sample.mean(), "reward_greedy": r_greedy.mean(),
                "advantage": advantage.mean()}

    return step


class ScstTrainer:
    """SCST of the prefix captioner against a frozen CLIP: per-epoch greedy
    validation (the mean reward over the validation set), an early stop
    once it reaches ``cfg.target_reward``, per-epoch checkpoints. Runs on
    ``cuda`` unless ``device="cpu"`` is asked for; ``generator`` (or
    ``seed``) draws the captioner's weights when ``params`` is None."""

    def __init__(self, clip_params: Params, clip_cfg: CLIPConfig, cap_cfg: CaptionerConfig | None = None,
                 cfg: ScstConfig | None = None, seed: int = 0, params: Params | None = None, device=None):
        self.device = resolve_device(device)
        self.clip_params = params_from_numpy(clip_params, self.device)
        self.clip_cfg = clip_cfg
        self.cap_cfg = cap_cfg or CaptionerConfig()
        self.cfg = cfg or ScstConfig()
        if params is None:
            params = init_captioner_params(torch.Generator().manual_seed(seed), self.cap_cfg)
        self.params = params_from_numpy(params, self.device)
        self.optimizer = ScstOptimizer(self.cfg)
        self.opt_state = self.optimizer.init(self.params)
        self.scst_step = make_scst_step(self.cap_cfg, self.clip_cfg, self.cfg, self.optimizer)
        self.history: list[dict] = []

    def _feats(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float32)).to(self.device)

    def xe_step(self, image_emb: torch.Tensor, tokens: torch.Tensor, valid: torch.Tensor) -> float:
        """One teacher-forced update; the batch's loss before it."""
        loss, grads = value_and_grads(
            lambda p: xe_caption_loss(p, self.cap_cfg, image_emb, tokens, valid), self.params)
        self.optimizer.apply(self.params, grads, self.opt_state)
        return float(loss)

    def pretrain_xe(self, image_features, tokens, epochs: int = 1) -> list[float]:
        """Teacher-forced warm start on (image feature, caption buffer)
        pairs; ``tokens`` [N, buf_len], SOT first, 0 after EOT."""
        feats = self._feats(image_features)
        toks = torch.as_tensor(np.asarray(tokens)).long().to(self.device)
        valid = _valid_from_tokens(toks, self.cap_cfg.eot_id)
        bs, losses = self.cfg.batch_size, []
        for _ in range(epochs):
            for i in range(0, feats.shape[0], bs):
                losses.append(self.xe_step(feats[i:i + bs], toks[i:i + bs], valid[i:i + bs]))
        return losses

    def mean_greedy_reward(self, image_features) -> float:
        """The greedy decode's mean reward over a set of image features."""
        feats = self._feats(image_features)
        toks, _ = generate(self.params, self.cap_cfg, feats, sample=False)
        with torch.no_grad():
            r = clip_text_reward(self.clip_params, self.clip_cfg, feats, toks, eot_id=self.cap_cfg.eot_id)
        return float(r.mean())

    def fit(self, train_features, val_features=None, epochs: int = 1, seed: int = 42,
            save_checkpoints: bool = False) -> list[dict]:
        """SCST epochs over shuffled full batches (``seed`` draws the orders
        and the samples); stops early once the validation reward reaches
        ``cfg.target_reward``."""
        feats = np.asarray(train_features, np.float32)
        if feats.shape[0] == 0:
            raise ValueError("fit() needs at least one training example")
        bs = min(self.cfg.batch_size, feats.shape[0])
        n_full = (feats.shape[0] // bs) * bs
        order_gen = torch.Generator().manual_seed(seed)
        sample_gen = torch.Generator(device=self.device).manual_seed(seed + 1)
        for epoch in range(epochs):
            order = torch.randperm(feats.shape[0], generator=order_gen).numpy()
            rewards = []
            for i in range(0, n_full, bs):
                m = self.scst_step(self.params, self.opt_state, self.clip_params,
                                   self._feats(feats[order[i:i + bs]]), sample_gen)
                rewards.append(float(m["reward_sample"]))
            entry = {"epoch": epoch, "train_reward": float(np.mean(rewards)) if rewards else 0.0}
            if val_features is not None:
                entry["val_reward"] = self.mean_greedy_reward(val_features)
            self.history.append(entry)
            if save_checkpoints:
                self.save_checkpoint(f"scst_epoch{epoch + 1}")
            if entry.get("val_reward", -1.0) >= self.cfg.target_reward:
                break
        if save_checkpoints:
            self.save_checkpoint("scst_final")
        return self.history

    # -- checkpoints ------------------------------------------------------
    def checkpoint_path(self, name: str) -> pathlib.Path:
        return pathlib.Path(self.cfg.save_dir).absolute() / f"{name}.pt"

    def save_checkpoint(self, name: str) -> pathlib.Path:
        """``<save_dir>/<name>.pt`` holding ``{"params": the captioner's
        tree}`` (CPU tensors)."""
        path = self.checkpoint_path(name)
        path.parent.mkdir(parents=True, exist_ok=True)
        torch.save({"params": map_with_paths(self.params, lambda _, t: t.detach().cpu())}, path)
        return path

    def restore_checkpoint(self, name: str) -> None:
        """The captioner's params from a checkpoint; the optimizer restarts."""
        payload = torch.load(self.checkpoint_path(name), map_location=self.device, weights_only=True)
        self.params = params_from_numpy(payload["params"], self.device)
        self.opt_state = self.optimizer.init(self.params)


def load_captioner(path, device=None) -> Params:
    """A captioner's params from an ``ScstTrainer`` checkpoint file, on
    ``device`` (None = the card)."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    return params_from_numpy(payload["params"], resolve_device(device))


def _valid_from_tokens(tokens: torch.Tensor, eot_id: int) -> torch.Tensor:
    """The valid mask of an XE buffer: SOT through the first EOT."""
    is_eot = (tokens == eot_id).long()
    return (torch.cumsum(is_eot, dim=1) - is_eot) == 0


def encode_captions(captions: list[str], cap_cfg: CaptionerConfig, tokenizer=None) -> np.ndarray:
    """Captions → SCST buffers [N, buf_len] int32: SOT, at most
    ``max_new_tokens − 1`` ids, EOT, zeros."""
    if tokenizer is None:
        from evr_tpu_torch.tokenizer import get_default_tokenizer

        tokenizer = get_default_tokenizer()
    out = np.zeros((len(captions), cap_cfg.buf_len), np.int32)
    for i, text in enumerate(captions):
        row = [cap_cfg.sot_id, *tokenizer.encode(text)[: cap_cfg.max_new_tokens - 1], cap_cfg.eot_id]
        out[i, : len(row)] = row
    return out
