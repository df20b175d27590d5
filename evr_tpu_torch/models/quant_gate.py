"""int8 serving rank-agreement gate (PyTorch).

Counterpart of ``evr_tpu/models/quant_gate.py``: int8 block-linear
quantization (``models.quant``) perturbs embeddings, so serving int8 needs
proof that rankings survive. ``serve --params-dtype auto`` samples the
ingested corpus at boot, runs this gate against the engine's float weights,
and serves int8 only when it passes (bfloat16 otherwise, decision logged).

Pass bar: rank-1 agreement ≥ 99.5% of queries AND top-10 overlap ≥ 9/10 on
every query AND per-frame embedding cosine ≥ 0.999.
"""

from __future__ import annotations

import pathlib
from dataclasses import asdict, dataclass

import numpy as np
import torch

from evr_tpu_torch.models.clip import encode_staged_u8, encode_text
from evr_tpu_torch.models.quant import quantize_clip_params
from evr_tpu_torch.ops.preprocess import stage_image_fast

# The standing query set of the JAX package's gate: the retrieval phrasings
# this workload sees, plus generic scene/object/person queries.
DEFAULT_GATE_QUERIES: tuple[str, ...] = (
    "a person fighting on the street",
    "a crowd of people",
    "a car on the road",
    "two men in a room",
    "violence",
    "a person walking alone at night",
    "a group of students in a classroom",
    "an empty corridor",
    "a person riding a motorcycle",
    "people sitting around a table",
    "a dog running in a park",
    "a building on fire",
    "someone holding a weapon",
    "a police officer",
    "children playing football",
    "a woman carrying a bag",
    "traffic at an intersection",
    "a dark room with one light",
    "people dancing at a party",
    "a man falling to the ground",
)


@dataclass
class GateReport:
    passed: bool
    top1_agreement: float  # fraction of queries whose rank-1 frame agrees
    min_topk_overlap: int  # worst per-query |top-k_fp ∩ top-k_int8|
    mean_topk_overlap: float
    min_frame_cosine: float  # worst per-frame embedding agreement
    n_frames: int
    n_queries: int
    top_k: int
    top1_bar: float
    overlap_bar: int
    cosine_bar: float

    def as_dict(self) -> dict:
        return asdict(self)


def ranking_agreement(
    sims_ref: np.ndarray,
    sims_test: np.ndarray,
    top_k: int = 10,
) -> dict:
    """Compare two [N_frames, Q] similarity matrices: per-query rank-1
    agreement and top-k set overlap."""
    k = min(top_k, sims_ref.shape[0])
    top_ref = np.argsort(-sims_ref, axis=0)[:k]
    top_test = np.argsort(-sims_test, axis=0)[:k]
    top1 = float((top_ref[0] == top_test[0]).mean())
    overlaps = [
        len(set(top_ref[:, j]) & set(top_test[:, j]))
        for j in range(sims_ref.shape[1])
    ]
    return {
        "top1_agreement": top1,
        "min_topk_overlap": int(min(overlaps)),
        "mean_topk_overlap": float(np.mean(overlaps)),
        "top_k": k,
    }


def _unit(e: np.ndarray) -> np.ndarray:
    e = e.astype(np.float32)
    return e / np.maximum(np.linalg.norm(e, axis=-1, keepdims=True), 1e-12)


def _encode_staged_with(engine, params, staged: np.ndarray) -> np.ndarray:
    """Batched frame encode through the engine's serving path with explicit
    params (the float reference or the int8 candidate)."""
    outs = []
    bs = engine.batch_size
    with torch.inference_mode():
        for i in range(0, len(staged), bs):
            batch, n = engine._pad_batch(staged[i : i + bs])
            x = torch.from_numpy(np.ascontiguousarray(batch)).to(engine.device)
            emb = encode_staged_u8(params, engine.cfg, x, dtype=engine.compute_dtype)
            outs.append(emb.cpu().numpy()[:n])
    return _unit(np.concatenate(outs, axis=0))


def _encode_texts_with(engine, params, queries) -> np.ndarray:
    toks = np.asarray(
        engine.tokenizer(list(queries), context_length=engine.cfg.text.context_length)
    )
    outs = []
    bs = engine.batch_size
    with torch.inference_mode():
        for i in range(0, len(toks), bs):
            batch, n = engine._pad_batch(toks[i : i + bs])
            emb = encode_text(
                params, engine.cfg, torch.from_numpy(batch).to(engine.device),
                dtype=engine.compute_dtype, eot_fast_final=True,
            )
            outs.append(emb.cpu().numpy()[:n])
    return _unit(np.concatenate(outs, axis=0))


def run_quant_gate(
    engine,
    staged_frames: np.ndarray,
    queries=DEFAULT_GATE_QUERIES,
    top_k: int = 10,
    top1_bar: float = 0.995,
    overlap_bar: int = 9,
    cosine_bar: float = 0.999,
) -> GateReport:
    """Gate the engine's CURRENT (fp/bf16) weights against their int8
    quantization on real staged frames [N, S, S, 3] uint8."""
    params = engine.params
    qp = quantize_clip_params(params)

    e_ref = _encode_staged_with(engine, params, staged_frames)
    e_q = _encode_staged_with(engine, qp, staged_frames)
    t_ref = _encode_texts_with(engine, params, queries)
    t_q = _encode_texts_with(engine, qp, queries)

    cos = (e_ref * e_q).sum(-1)
    agree = ranking_agreement(e_ref @ t_ref.T, e_q @ t_q.T, top_k=top_k)
    k = agree["top_k"]
    eff_overlap_bar = min(overlap_bar, k)  # tiny corpora can't reach 9/10
    passed = (
        agree["top1_agreement"] >= top1_bar
        and agree["min_topk_overlap"] >= eff_overlap_bar
        and float(cos.min()) >= cosine_bar
    )
    return GateReport(
        passed=passed,
        top1_agreement=agree["top1_agreement"],
        min_topk_overlap=agree["min_topk_overlap"],
        mean_topk_overlap=agree["mean_topk_overlap"],
        min_frame_cosine=float(cos.min()),
        n_frames=len(staged_frames),
        n_queries=len(queries),
        top_k=k,
        top1_bar=top1_bar,
        overlap_bar=eff_overlap_bar,
        cosine_bar=cosine_bar,
    )


def sample_corpus_frames(data_root, image_size: int, limit: int = 256) -> np.ndarray:
    """Stage up to ``limit`` frames sampled evenly across every ingested
    video's frames_dir (deterministic stride, so re-boots gate the same
    corpus). An empty root gives 64 seeded synthetic frames, as the JAX
    package does, so a fresh boot still exercises the numerics."""
    frames_root = pathlib.Path(data_root.frames_dir)
    paths = sorted(frames_root.glob("*/*.jpg")) + sorted(frames_root.glob("*/*.png"))
    if paths:
        if len(paths) > limit:
            stride = len(paths) / limit
            paths = [paths[int(i * stride)] for i in range(limit)]
        staged = []
        for p in paths:
            try:
                staged.append(stage_image_fast(p, image_size))
            except OSError:
                continue
        if staged:
            return np.stack(staged)
    rng = np.random.default_rng(0)
    return (rng.random((64, image_size, image_size, 3)) * 255).astype(np.uint8)


def auto_params_dtype(
    engine, data_root, limit: int = 256, log=None, fallback: str = "bfloat16"
) -> GateReport:
    """``--params-dtype auto``: run the gate over the ingested corpus and
    promote the engine to int8 in place when it passes; otherwise cast to
    ``fallback`` (bf16). Returns the report for logging."""
    staged = sample_corpus_frames(data_root, engine.cfg.vision.image_size, limit)
    report = run_quant_gate(engine, staged)
    engine.set_params_dtype("int8" if report.passed else fallback)
    if log is not None:
        log.info(
            "int8 gate %s: top1=%.4f min_overlap=%d/%d min_cos=%.5f "
            "(%d frames, %d queries) -> serving %s",
            "PASSED" if report.passed else "FAILED",
            report.top1_agreement,
            report.min_topk_overlap,
            report.top_k,
            report.min_frame_cosine,
            report.n_frames,
            report.n_queries,
            engine.params_dtype,
        )
    return report
