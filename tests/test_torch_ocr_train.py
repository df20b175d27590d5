"""The port's OCR trainer (``evr_tpu_torch/ingest/ocr.py``,
``tools/train_ocr.py``) against the JAX package's on the CPU: the CTC loss
against ``optax.ctc_loss`` (1e-5 relative), one batch's gradients against
``jax.grad`` of JAX's loss (5e-3 of each leaf's largest entry, the ROADMAP's
gradient tolerance), the schedule against optax's, the minibatch draws, three
steps of the whole optimiser chain from carried params (params per leaf, the
updates by cosine: Adam's first moves are nearly sign vectors), forty steps
that bring the loss under the JAX test's bar, and the CLI's checkpoint read
by both packages."""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from evr_tpu.ingest import ocr as J
from evr_tpu_torch.ingest import ocr as T
from torch_threads import one_torch_thread  # noqa: F401

CTC_REL = 1e-5
GRAD_TOL = 5e-3
PARAM_TOL = 1e-4  # three steps of at most ~lr each from the same point
UPDATE_COS = 0.999


def _carried(seed=0):
    jp = J.init_ocr_params(jax.random.PRNGKey(seed))
    return jp, {k: np.asarray(v) for k, v in jp.items()}


def test_ctc_loss_matches_optax():
    rng = np.random.default_rng(0)
    b, t, c, n = 8, 64, T.N_CLASSES, T.MAX_LABEL
    logits = rng.normal(0, 3, (b, t, c)).astype(np.float32)
    labels = np.zeros((b, n), np.int32)
    pads = np.ones((b, n), np.float32)
    for i, length in enumerate((1, 3, 7, 12, 17, 24, 5, 9)):
        labels[i, :length] = rng.integers(1, c, length)
        pads[i, :length] = 0.0
    labels[1, :3] = (5, 5, 5)  # repeats need a blank between them
    labels[2, :7] = (7, 7, 8, 8, 9, 9, 7)
    ref = np.asarray(optax.ctc_loss(jnp.asarray(logits), jnp.zeros((b, t)), jnp.asarray(labels),
                                    jnp.asarray(pads), blank_id=0))
    got = T.ctc_loss(torch.from_numpy(logits), torch.from_numpy(labels), torch.from_numpy(pads)).numpy()
    assert got.shape == (b,)
    np.testing.assert_allclose(got, ref, rtol=CTC_REL, atol=0)


def test_gradients_match_jax():
    jp, np_params = _carried(0)
    imgs, labels, pads, _ = J.make_dataset(16, seed=1)

    def loss_fn(p, bx, by, byp):  # the JAX trainer's loss_fn
        logits = J.ocr_logits(p, bx)
        return optax.ctc_loss(logits, jnp.zeros(logits.shape[:2]), by, byp, blank_id=0).mean()

    ref_loss, ref = jax.value_and_grad(loss_fn)(jp, jnp.asarray(imgs), jnp.asarray(labels), jnp.asarray(pads))
    loss, grads = T.grads_of(T.params_to(np_params, "cpu"), torch.from_numpy(imgs),
                             torch.from_numpy(labels), torch.from_numpy(pads))
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=CTC_REL)
    assert sorted(grads) == sorted(ref)
    for k, g in grads.items():
        r = np.asarray(ref[k])
        assert np.abs(g.numpy() - r).max() <= GRAD_TOL * np.abs(r).max(), k


def test_schedule_and_minibatches_match_jax():
    for steps, lr in ((3, 1e-3), (40, 1e-3), (2000, 3e-4)):
        opt = T.OCROptimizer(steps, lr)
        ref = optax.warmup_cosine_decay_schedule(0.0, lr, min(100, max(1, steps // 10)), steps, lr * 0.05)
        counts = sorted({0, 1, opt.warmup - 1, opt.warmup, opt.warmup + 1, steps // 2, steps - 1, steps,
                         steps + 5})
        for count in counts:
            np.testing.assert_allclose(float(opt.adamw.learning_rate(count)), float(ref(count)),
                                       rtol=1e-6, atol=1e-12)
    rng = np.random.default_rng(4)
    want = np.concatenate([rng.integers(0, 50, size=(k, 6)) for k in (100, 100, 37)])
    assert np.array_equal(np.stack(list(T.minibatch_indices(237, 6, 50, 3))), want)


def test_three_steps_match_jax():
    jp, np_params = _carried(2)
    kw = dict(steps=3, batch=8, dataset_size=32, seed=0)
    ref, ref_m = J.train_ocr(params=jp, **kw)
    got, got_m = T.train_ocr(params=np_params, device="cpu", **kw)
    np.testing.assert_allclose(got_m["loss"], ref_m["loss"], rtol=1e-5)
    assert got_m["acc"] == ref_m["acc"]
    assert sorted(got) == sorted(ref)
    for k, p0 in np_params.items():
        g, r = got[k].numpy(), np.asarray(ref[k])
        np.testing.assert_allclose(g, r, rtol=0, atol=PARAM_TOL)
        du, dr = (g - p0).ravel(), (r - p0).ravel()
        cos = float(du @ dr / (np.linalg.norm(du) * np.linalg.norm(dr)))
        assert cos >= UPDATE_COS, (k, cos)


def test_forty_steps_reduce_the_loss():
    p0 = T.init_ocr_params(torch.Generator().manual_seed(0))
    params, metrics = T.train_ocr(steps=40, batch=16, dataset_size=64, seed=0, params=p0, device="cpu")
    # JAX's CPU test: the loss at a random init is about 93-100 a sequence;
    # 40 steps must bring it under 85
    assert metrics["loss"] < 85.0
    assert not torch.allclose(params["out_w"], p0["out_w"])
    assert sorted(p0) == sorted(J.init_ocr_params(jax.random.PRNGKey(0)))
    for k, v in J.init_ocr_params(jax.random.PRNGKey(0)).items():
        assert tuple(p0[k].shape) == v.shape and p0[k].dtype == torch.float32


def test_train_ocr_cli_checkpoint_loads_in_both_packages(tmp_path, capsys):
    from evr_tpu_torch.tools import train_ocr

    out = tmp_path / "ocr.npz"
    metrics = train_ocr.main(["--steps", "3", "--batch", "4", "--dataset-size", "8", "--eval-n", "8",
                              "--log-every", "0", "--device", "cpu", "--out", str(out)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["checkpoint"] == str(out) and line["steps"] == 3
    assert set(line) == {"checkpoint", "loss", "acc", "acc_heldout", "train_s", "steps"}
    assert set(metrics) == set(line) - {"checkpoint"}
    got, ref = T.load_checkpoint(out), J.load_checkpoint(out)
    assert sorted(got) == sorted(ref) == sorted(T.init_ocr_params())
    for k in ref:
        assert np.array_equal(got[k].numpy(), np.asarray(ref[k]))
    with np.load(out) as z:
        assert json.loads(z["__meta__"].tobytes())["steps"] == 3
    # a checkpoint of another charset is refused
    bad = dict(np.load(out))
    bad["__charset__"] = np.frombuffer(b"abc", np.uint8)
    np.savez(tmp_path / "bad.npz", **bad)
    with pytest.raises(ValueError, match="charset"):
        T.load_checkpoint(tmp_path / "bad.npz")


def test_entry_points_run_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.LocalOCRAnnotator()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.train_ocr(steps=1, batch=2, dataset_size=2)
    from evr_tpu_torch.tools import train_ocr

    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_ocr.main(["--steps", "1", "--out", "unused.npz"])


def test_grads_of_runs_forward_and_backward_in_fp32(monkeypatch):
    """The caller allows TF32; every saved tensor the backward unpacks is
    read while the module holds TF32 off, and the caller's flags come back."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    imgs, labels, pads, _ = J.make_dataset(2, seed=1)
    seen = []

    def unpack(t):
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
        return t

    with torch.autograd.graph.saved_tensors_hooks(lambda t: t, unpack):
        T.grads_of(T.params_to(_carried(0)[1], "cpu"), torch.from_numpy(imgs),
                   torch.from_numpy(labels), torch.from_numpy(pads))
    assert seen and set(seen) == {(False, False)}
    assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32


def test_full_fp32_holds_until_the_last_overlapping_caller_leaves(monkeypatch):
    """Two callers (two server threads) whose spans overlap without nesting:
    the first to leave must not hand TF32 back to the second."""
    from evr_tpu_torch.utils.device import full_fp32

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    first, second = full_fp32(), full_fp32()
    first.__enter__()
    second.__enter__()
    first.__exit__(None, None, None)
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    second.__exit__(None, None, None)
    assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
