"""The port's sustained fine-tune tool (``tools/train_sustained.py``)
against ``evr_tpu.tools.train_sustained`` on the CPU: the rendered corpus
bit-equal for one seed, the retrieval metric equal on seeded features, and
the tool end to end at ViT-Tiny-Test with its printed lines."""

import numpy as np

from evr_tpu.tools import train_sustained as jts
from evr_tpu_torch.tools import train_sustained as tts


def test_make_dataset_bit_equal_to_jax():
    got, want = tts.make_dataset(24, 64, seed=1), jts.make_dataset(24, 64, seed=1)
    assert got[0].shape == (24, 64, 64, 3) and got[0].dtype == np.uint8
    assert np.array_equal(got[0], want[0])
    assert got[1] == want[1] and np.array_equal(got[2], want[2]) and got[3] == want[3]
    assert len(set(got[1])) > 5 and got[2].max() < 4


def test_retrieval_at_k_matches_jax():
    rng = np.random.default_rng(2)
    img, txt = rng.standard_normal((40, 16)).astype(np.float32), rng.standard_normal((40, 16)).astype(np.float32)
    assert tts.retrieval_at_k(img, txt) == jts.retrieval_at_k(img, txt)
    f = np.eye(8, 16, dtype=np.float32)
    assert tts.retrieval_at_k(f, f, ks=(1, 5)) == {"R@1": 1.0, "R@5": 1.0}


def test_tool_end_to_end_tiny(capsys):
    out = tts.main(["--model", "ViT-Tiny-Test", "--batch", "8", "--pool", "2", "--steps", "4",
                    "--holdout", "16", "--lr", "3e-3", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "sustained:" in printed and "LIFT: R@5" in printed and "uploaded once" in printed
    assert out["steps"] == 4 and out["sustained_ex_per_s"] > 0
    assert np.isfinite(out["first_loss"]) and np.isfinite(out["last_loss"])
    assert set(out["before"]) == set(out["after"]) == {"R@1", "R@5", "R@10"}
