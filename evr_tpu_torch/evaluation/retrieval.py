"""Retrieval evaluation: R@K, MRR, Median/Mean Rank, P@K, rsum (PyTorch).

Counterpart of ``evr_tpu/evaluation/retrieval.py``, with the reference
benchmark harness's protocol (`Backend/content/Test_compare_model/
compare_models.py`):

- t2i: for each caption, rank of its ground-truth image in the similarity
  column (`:1004-1027`);
- i2t: for each image, best rank among its (typically 5) captions
  (`:1044-1073`, standard Flickr30k protocol);
- ``mean`` direction-average and ``rsum`` = Σ R@{1,5,10} over both
  directions (`:1079-1088`);
- multi-ground-truth metrics with P@K for the Excel test sets
  (`calculate_metrics`, `:757-787`).

The similarity matrix is one fp32 GEMM of unit rows on the device
(``_similarity_matrix``, TF32 off); ranks are counted on the host by
strictly-greater counting (rank = 1 + #{sims > sim[gt]}), equal to the
reference's argsort-position ranks for untied scores and optimistic under
exact ties. ``calculate_metrics`` orders by ``np.argsort(-sims)`` as the
JAX package does, so its tie order is numpy's.
"""

from __future__ import annotations

import numpy as np
import torch

from evr_tpu_torch.utils.device import full_fp32, resolve_device

METRIC_KEYS = ("R@1", "R@5", "R@10", "MRR", "Median_Rank", "Mean_Rank")


def _similarity_matrix(image_features: np.ndarray, text_features: np.ndarray, device) -> np.ndarray:
    """[N, D] x [M, D] → [N, M] cosine similarities: rows made unit, one
    fp32 GEMM on ``device``, the result back on the host."""
    dev = resolve_device(device)
    img = torch.from_numpy(np.ascontiguousarray(image_features, np.float32)).to(dev)
    txt = torch.from_numpy(np.ascontiguousarray(text_features, np.float32)).to(dev)
    img = img / torch.linalg.vector_norm(img, dim=-1, keepdim=True)
    txt = txt / torch.linalg.vector_norm(txt, dim=-1, keepdim=True)
    with full_fp32():
        return (img @ txt.T).cpu().numpy()


def metrics_from_ranks(ranks: np.ndarray) -> dict[str, float]:
    ranks = np.asarray(ranks)
    if len(ranks) == 0:
        return {k: float("nan") for k in METRIC_KEYS}
    return {
        "R@1": float((ranks <= 1).mean()),
        "R@5": float((ranks <= 5).mean()),
        "R@10": float((ranks <= 10).mean()),
        "MRR": float((1.0 / ranks).mean()),
        "Median_Rank": float(np.median(ranks)),
        "Mean_Rank": float(np.mean(ranks)),
    }


def _ranks_of(sim_cols: np.ndarray, gt_rows: np.ndarray) -> np.ndarray:
    """rank of gt_rows[i] within column i of sim_cols ([N, M] sims, M queries)."""
    gt_scores = sim_cols[gt_rows, np.arange(sim_cols.shape[1])]
    return 1 + (sim_cols > gt_scores[None, :]).sum(axis=0)


def evaluate_retrieval(
    image_features: np.ndarray,  # [N, D] one row per image
    text_features: np.ndarray,  # [M, D] one row per caption
    caption_image_ids: list,  # len M: image id each caption belongs to
    image_ids: list,  # len N: id of each image row
    normalise: bool = True,
    device=None,
) -> dict:
    """Full dual-direction evaluation (t2i + i2t + mean + rsum). With
    ``normalise`` the similarities are the GEMM of unit rows on ``device``
    (None: the card; "cpu" on request), else the host product of the rows
    as given."""
    img = np.asarray(image_features, np.float32)
    txt = np.asarray(text_features, np.float32)
    if normalise:
        sim = _similarity_matrix(img, txt, device)
    else:
        sim = img @ txt.T  # [N, M]

    id_to_row = {image_id: i for i, image_id in enumerate(image_ids)}

    # t2i: caption j → rank of its image among all images
    valid = [(j, id_to_row[cid]) for j, cid in enumerate(caption_image_ids) if cid in id_to_row]
    cols = np.asarray([j for j, _ in valid])
    gts = np.asarray([g for _, g in valid])
    t2i_ranks = _ranks_of(sim[:, cols], gts)
    t2i = metrics_from_ranks(t2i_ranks)

    # i2t: image i → best rank among its captions
    captions_of: dict = {}
    for j, cid in enumerate(caption_image_ids):
        captions_of.setdefault(cid, []).append(j)
    i2t_ranks = []
    simT = sim.T  # [M, N]
    for i, image_id in enumerate(image_ids):
        gt_captions = captions_of.get(image_id, [])
        if not gt_captions:
            continue
        ranks = _ranks_of(simT[:, [i] * len(gt_captions)], np.asarray(gt_captions))
        i2t_ranks.append(int(ranks.min()))
    i2t = metrics_from_ranks(np.asarray(i2t_ranks))

    mean = {k: (t2i[k] + i2t[k]) / 2 for k in METRIC_KEYS}
    mean["rsum"] = (
        t2i["R@1"] + t2i["R@5"] + t2i["R@10"] + i2t["R@1"] + i2t["R@5"] + i2t["R@10"]
    )
    return {
        "t2i": t2i,
        "i2t": i2t,
        "mean": mean,
        "t2i_ranks": t2i_ranks.tolist(),
        "i2t_ranks": list(map(int, i2t_ranks)),
    }


def calculate_metrics(
    similarities: np.ndarray, ground_truth_indices: list[list[int]]
) -> tuple[dict, np.ndarray]:
    """Multi-ground-truth variant with P@K (`compare_models.py:757-787`):
    per query, rank = best rank among its ground-truth indices; P@K = mean
    fraction of top-K that are ground truth. ``similarities`` is [Q, N] (or
    [N] for a single query shared across GT sets, as the reference uses it).
    """
    sims = np.atleast_2d(np.asarray(similarities))
    if sims.shape[0] == 1 and len(ground_truth_indices) > 1:
        sims = np.repeat(sims, len(ground_truth_indices), axis=0)

    ranks = []
    p_at_k = {1: 0.0, 5: 0.0, 10: 0.0}
    for q, gt in enumerate(ground_truth_indices):
        order = np.argsort(-sims[q])
        positions = {int(idx): p for p, idx in enumerate(order)}
        gt_ranks = [positions[int(g)] + 1 for g in gt if int(g) in positions]
        ranks.append(min(gt_ranks) if gt_ranks else len(order) + 1)
        for k in p_at_k:
            top_k = set(map(int, order[:k]))
            hits = sum(1 for g in gt if int(g) in top_k)
            p_at_k[k] += hits / k
    ranks = np.asarray(ranks)
    metrics = metrics_from_ranks(ranks)
    for k, total in p_at_k.items():
        metrics[f"P@{k}"] = total / len(ground_truth_indices)
    return metrics, ranks
