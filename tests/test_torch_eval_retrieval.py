"""The port's retrieval metrics (``evaluation.retrieval``, ``datasets``)
against ``evr_tpu.evaluation`` on the CPU.

Seeded features whose every similarity lies more than 1e-5 from the score
it is ranked against (checked in float64 before use), so the two packages'
GEMMs (the port's in torch, fp32, TF32 off) cannot order them apart; plus
exact ties from duplicated image and caption rows, where both packages give
the optimistic rank (1 + the count of strictly greater scores). Ranks are
held exact, metrics at 1e-5.
"""

import numpy as np
import pytest

from evr_tpu.evaluation import datasets as jdatasets
from evr_tpu.evaluation import retrieval as jret
from evr_tpu_torch.evaluation import datasets as tdatasets
from evr_tpu_torch.evaluation import retrieval as tret

METRIC_TOL = 1e-5
GAP = 1e-5


def _assert_results_match(got: dict, ref: dict):
    assert got.keys() == ref.keys()
    for direction in ("t2i", "i2t", "mean"):
        assert got[direction].keys() == ref[direction].keys()
        for k, v in ref[direction].items():
            np.testing.assert_allclose(got[direction][k], v, rtol=0, atol=METRIC_TOL, err_msg=f"{direction} {k}")
    assert got["t2i_ranks"] == ref["t2i_ranks"]
    assert got["i2t_ranks"] == ref["i2t_ranks"]


def seeded_set(seed: int = 0, n_img: int = 30, per: int = 5, d: int = 32):
    """(image features, caption features, caption image ids, image ids):
    image 4 duplicates image 3, caption 7 duplicates caption 2, one caption
    names an image that is not in the set. Raises if any score sits within
    GAP of a score it is ranked against, ties of duplicated rows apart."""
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((n_img, d)).astype(np.float32)
    img[4] = img[3]
    ids = [f"im{i}" for i in range(n_img)]
    cap_ids = [ids[i] for i in range(n_img) for _ in range(per)] + ["missing"]
    gt = np.asarray([ids.index(c) if c in ids else 0 for c in cap_ids])
    txt = (img[gt] + 1.5 * rng.standard_normal((len(cap_ids), d))).astype(np.float32)
    txt[7] = txt[2]
    u = img / np.linalg.norm(img, axis=1, keepdims=True)
    v = txt / np.linalg.norm(txt, axis=1, keepdims=True)
    sim = u.astype(np.float64) @ v.astype(np.float64).T
    for j in range(len(cap_ids)):
        col = np.delete(sim[:, j], [3, 4] if gt[j] in (3, 4) else [gt[j]])
        assert np.abs(col - sim[gt[j], j]).min() > GAP
    return img, txt, cap_ids, ids


@pytest.mark.parametrize("normalise", [True, False])
def test_evaluate_retrieval_matches_jax(normalise):
    img, txt, cap_ids, ids = seeded_set()
    got = tret.evaluate_retrieval(img, txt, cap_ids, ids, normalise=normalise, device="cpu")
    ref = jret.evaluate_retrieval(img, txt, cap_ids, ids, normalise=normalise)
    _assert_results_match(got, ref)
    assert len(got["t2i_ranks"]) == len(cap_ids) - 1  # the caption of a missing image is left out


def test_exact_ties_take_the_optimistic_rank_in_both():
    img, txt, cap_ids, ids = seeded_set()
    got = tret.evaluate_retrieval(img, txt, cap_ids, ids, device="cpu")
    ref = jret.evaluate_retrieval(img, txt, cap_ids, ids)
    sim = tret._similarity_matrix(img, txt, "cpu")
    # images 3 and 4 are one row twice: their scores tie exactly, and
    # neither counts against the other's captions
    np.testing.assert_array_equal(sim[3], sim[4])
    for j in range(15, 25):  # the captions of images 3 and 4
        gt = ids.index(cap_ids[j])
        assert got["t2i_ranks"][j] == 1 + int((sim[:, j] > sim[gt, j]).sum())
        assert got["t2i_ranks"][j] == ref["t2i_ranks"][j]
    # caption 7 duplicates caption 2 (image 0's): image 0's best rank counts neither
    np.testing.assert_array_equal(sim[:, 2], sim[:, 7])
    assert got["i2t_ranks"] == ref["i2t_ranks"]


def test_similarity_matrix_is_the_fp32_gemm_of_unit_rows():
    img, txt, _, _ = seeded_set(d=16)
    sim = tret._similarity_matrix(img, txt, "cpu")
    ref = np.asarray(jret._similarity_matrix(img, txt))
    assert sim.dtype == np.float32 and sim.shape == (len(img), len(txt))
    np.testing.assert_allclose(sim, ref, rtol=0, atol=1e-6)


def test_calculate_metrics_with_p_at_k_matches_jax():
    rng = np.random.default_rng(3)
    sims = rng.standard_normal((12, 40)).astype(np.float32)
    sims[:, 9] = sims[:, 4]  # tied columns: argsort's order, the same numpy call in both
    gts = [list(rng.choice(40, size=int(rng.integers(1, 4)), replace=False)) for _ in range(12)]
    gts[0] = [4, 9]
    gts[1] = []
    for s in (sims, sims[0]):  # per query, and one query shared across GT sets
        got, got_ranks = tret.calculate_metrics(s, gts)
        ref, ref_ranks = jret.calculate_metrics(s, gts)
        assert got.keys() == ref.keys() and {"P@1", "P@5", "P@10"} <= set(got)
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=METRIC_TOL, err_msg=k)
        np.testing.assert_array_equal(got_ranks, ref_ranks)


def test_metrics_from_ranks_match_jax():
    for ranks in (np.array([1, 2, 11, 4]), np.arange(1, 40), np.array([], dtype=int)):
        got, ref = tret.metrics_from_ranks(ranks), jret.metrics_from_ranks(ranks)
        assert got.keys() == ref.keys()
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=METRIC_TOL, err_msg=k)


def test_caption_csv_and_folder_loaders_match_jax(tmp_path):
    for i in range(5):
        (tmp_path / f"{i}.jpg").write_bytes(b"x")
    (tmp_path / "notes.txt").write_text("not an image")
    csv_path = tmp_path / "results.csv"
    rows = ["image_name| comment_number| comment"]
    rows += [f"{i}.jpg| {c}| caption {c} of image {i}" for i in (0, 1, 2, 3, 4, 9) for c in range(3)]
    rows += ["short|row"]
    csv_path.write_text("\n".join(rows))
    for max_images in (None, 3):
        got = tdatasets.load_captions_csv(csv_path, tmp_path, max_images=max_images)
        ref = jdatasets.load_captions_csv(csv_path, tmp_path, max_images=max_images)
        assert got.__dict__ == ref.__dict__
        got = tdatasets.synthesize_from_folder(tmp_path, max_images=max_images)
        ref = jdatasets.synthesize_from_folder(tmp_path, max_images=max_images)
        assert got.__dict__ == ref.__dict__ and got.ordered_paths == ref.ordered_paths


def test_similarity_on_the_card_unless_the_cpu_is_asked_for(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img, txt, cap_ids, ids = seeded_set()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tret.evaluate_retrieval(img, txt, cap_ids, ids)
