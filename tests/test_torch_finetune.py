"""The port's Trainer and fine-tune CLI on the CPU, and the guard that keeps
kernel results out of autograd.

- ``Trainer.fit``: early stopping, best and final checkpoints (torch files
  with the JAX trainer's payload keys), resume from a final checkpoint and
  from a mid-epoch autosave, each held bit for bit to an uninterrupted run;
- ``python -m evr_tpu_torch.tools.finetune`` on a synthetic caption JSON
  with ``ViT-Tiny-Test`` and ``--device cpu``; the flags and TrainConfig
  values the port does not honour yet (MoE and expert parallelism, A17) are refused,
  naming their ROADMAP item;
- the kernel wrappers refuse inputs that require grad, and a differentiable
  block never comes back detached.

The JAX package's trainer is the reference of ``tests/test_torch_training.py``;
this file needs only the port.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from evr_tpu_torch.models import clip as tclip
from evr_tpu_torch.models.classifier import ClassifierConfig, init_classifier_params
from evr_tpu_torch.models.convert import params_from_numpy
from evr_tpu_torch.models.layers import block_apply
from evr_tpu_torch.ops import block_fused as tbf
from evr_tpu_torch.ops.retrieval import fused_topk
from evr_tpu_torch.tools import finetune as cli
from evr_tpu_torch.training import TrainConfig, Trainer, check_supported
from evr_tpu_torch.training.finetune import flat_leaves


def tiny_cfg():
    return tclip.CLIPConfig(
        embed_dim=32,
        vision=tclip.VisionConfig(image_size=32, patch_size=8, width=64, layers=2, heads=4),
        text=tclip.TextConfig(context_length=16, vocab_size=600, width=64, layers=2, heads=4),
    )


def tiny_batches(seed, n_batches, n=4):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        tokens = np.zeros((n, 16), np.int32)
        for i in range(n):
            ln = int(rng.integers(3, 10))
            tokens[i, :ln] = rng.integers(1, 500, size=ln)
            tokens[i, ln] = 599
        out.append({"images": (rng.random((n, 32, 32, 3)) * 255).astype(np.uint8),
                    "tokens": tokens, "labels": rng.integers(0, 3, size=n).astype(np.int32)})
    return out


TRAIN, VAL = tiny_batches(1, 3), tiny_batches(2, 1)


def make_trainer(tmp_path, **kw):
    cfg = TrainConfig(**{"compute_dtype": "float32", "batch_size": 4, "lr": 1e-3,
                         "save_dir": str(tmp_path), **kw})
    return Trainer(
        tiny_cfg(), tclip.init_clip_params(0, tiny_cfg()), cfg,
        classifier_params=init_classifier_params(1, ClassifierConfig(embed_dim=32)),
        cls_cfg=ClassifierConfig(embed_dim=32, dropout=0.0), steps_per_epoch=len(TRAIN),
        log_fn=lambda s: None, device="cpu",
    )


def fit(trainer, resume_from=None):
    return trainer.fit(lambda e: iter(TRAIN), lambda e: iter(VAL), resume_from=resume_from)


def params_np(trainer):
    return {k: v.detach().numpy().copy() for k, v in flat_leaves(trainer.state.params).items()}


def test_fit_early_stopping_best_and_final_checkpoints(tmp_path):
    # lr 0: the validation loss never improves after epoch 0
    trainer = make_trainer(tmp_path, lr=0.0, epochs=6, early_stopping=2)
    result = fit(trainer)
    assert [r["epoch"] for r in result["history"]] == [0, 1, 2]
    assert result["best_epoch"] == 0 and np.isfinite(result["best_val_loss"])
    assert [name for name, _ in result["checkpoint_seconds"]] == ["best_model", "final_checkpoint"]
    row = result["history"][-1]
    assert row["train_batches"] == 3 and row["val_batches"] == 1
    assert np.isfinite(row["train_grad_norm"])
    payload = torch.load(trainer.checkpoint_path("best_model"), weights_only=True)
    assert {"params", "opt_state", "step", "epoch", "metrics"} <= set(payload)
    assert payload["epoch"] == 0 and payload["step"] == 3
    assert payload["metrics"]["total_loss"] == pytest.approx(result["best_val_loss"])
    assert torch.load(trainer.checkpoint_path("final_checkpoint"), weights_only=True)["epoch"] == 2


def test_resume_from_final_checkpoint_matches_uninterrupted_run(tmp_path):
    whole = make_trainer(tmp_path / "a", epochs=2, ema_decay=0.5)
    fit(whole)
    first = make_trainer(tmp_path / "b", epochs=1, ema_decay=0.5)
    fit(first)
    second = make_trainer(tmp_path / "b", epochs=2, ema_decay=0.5)
    result = fit(second, resume_from="final_checkpoint")
    assert [r["epoch"] for r in result["history"]] == [1]
    assert second.state.step == whole.state.step == 6
    assert second.state.opt_state["count"] == 6
    want, got = params_np(whole), params_np(second)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    ema_w, ema_g = flat_leaves(whole.state.ema_params), flat_leaves(second.state.ema_params)
    for k in ema_w:
        np.testing.assert_array_equal(ema_g[k].numpy(), ema_w[k].numpy(), err_msg=k)


def test_preemption_autosave_resumes_mid_epoch(tmp_path):
    whole = make_trainer(tmp_path / "a", epochs=1)
    fit(whole)
    cut = make_trainer(tmp_path / "b", epochs=1, save_every_steps=2)
    cut._preempted = True  # as the SIGTERM handler of install_preemption_autosave sets it
    assert fit(cut)["preempted"] is True
    payload = torch.load(cut.checkpoint_path("autosave"), weights_only=True)
    assert payload["batches_done"] == 1 and payload["step"] == 1
    resumed = make_trainer(tmp_path / "b", epochs=1)
    result = fit(resumed, resume_from="autosave")
    assert result["history"][0]["train_batches"] == 2  # the two batches after the cut
    want, got = params_np(whole), params_np(resumed)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _caption_set(root, n):
    import cv2

    rng = np.random.default_rng(0)
    cats = ["Violence", "NonViolence", "Sensitive content"]
    meta = {}
    for i in range(n):
        img = (rng.random((48, 40, 3)) * 255).astype(np.uint8)
        cv2.imwrite(str(root / f"img{i}.jpg"), img)
        meta[f"img{i}.jpg"] = {"caption": f"a scene number {i}", "category": cats[i % 3]}
    meta["missing.jpg"] = {"caption": "not on disk"}
    path = root / "captions.json"
    path.write_text(json.dumps(meta))
    return path


def test_cli_trains_on_a_caption_json(tmp_path, capsys):
    js = _caption_set(tmp_path, 10)
    save = tmp_path / "ckpt"
    result = cli.main([
        "--train-json", str(js), "--data-dir", str(tmp_path), "--model", "ViT-Tiny-Test",
        "--device", "cpu", "--batch-size", "4", "--epochs", "1", "--save-dir", str(save),
    ])
    out = capsys.readouterr().out
    assert "train=8 val=2" in out  # 10 images on disk, an 80/20 split; the missing one dropped
    row = result["history"][0]
    assert row["train_batches"] == 2 and np.isfinite(row["train_total_loss"])
    assert (save / "final_checkpoint.pt").exists()
    assert json.loads((save / "history.json").read_text())["history"][0]["epoch"] == 0
    payload = torch.load(save / "final_checkpoint.pt", weights_only=True)
    assert payload["params"]["clip"]["visual"]["blocks"][0]["attn"]["qkv"]["kernel"].dtype == torch.float32


@pytest.mark.parametrize("flags, item", [
    # --fsdp runs since the mesh was ported (tests/test_torch_fsdp.py); the
    # MoE flags since the MoE towers were: (flags, experts in the checkpoint)
    (["--moe-router-k", "1"], 0), (["--moe-experts", "4"], 4),
    (["--moe-experts", "2", "--expert-parallel", "2"], 2),
])
def test_cli_refuses_unported_flags(tmp_path, monkeypatch, flags, item):
    """No flag of the JAX CLI is refused now: ``--moe-router-k`` alone
    trains the dense towers (as the JAX CLI), ``--moe-experts`` the MoE
    towers, ``--expert-parallel`` over a (data, expert) mesh of 2 CPU slots."""
    monkeypatch.setenv("EVR_TPU_CPU_DEVICES", "2")
    js = _caption_set(tmp_path, 6)
    cli.main(["--train-json", str(js), "--data-dir", str(tmp_path), "--model", "ViT-Tiny-Test",
              "--device", "cpu", "--batch-size", "4", "--epochs", "1", "--save-dir", str(tmp_path / "c"), *flags])
    payload = torch.load(tmp_path / "c" / "final_checkpoint.pt", weights_only=True)
    assert (payload["moe"]["n_experts"] if "moe" in payload else 0) == item


def test_unported_train_config_values_raise():
    """Every ``TrainConfig`` lever is ported: ``moe`` takes an ``MoEConfig``;
    values the trainer cannot take still raise."""
    from evr_tpu_torch.models.moe import MoEConfig

    check_supported(dataclasses.replace(TrainConfig(), moe=MoEConfig()))
    for name, value in (("optimizer", "sgd"), ("adam_mu_dtype", "float16"), ("contrastive_loss", "ce")):
        with pytest.raises(ValueError, match=name.split("_")[0]):
            check_supported(dataclasses.replace(TrainConfig(), **{name: value}))
    check_supported(TrainConfig(gradcache_chunks=1))


def test_kernel_wrappers_refuse_inputs_that_require_grad():
    """K1–K4 return results written outside autograd: under grad mode an
    input that requires grad raises instead of getting no gradient."""
    W = 64
    p = params_from_numpy(tclip.init_clip_params(0, tiny_cfg()))["visual"]["blocks"][0]
    attn, mlp = tbf.block_half_params(p)
    x = torch.zeros(2, 5, W)
    with pytest.raises(RuntimeError, match="fused_attn_block: an input requires grad"):
        tbf.fused_attn_block(x.clone().requires_grad_(), *attn, n_heads=4)
    w = mlp[2].clone().requires_grad_()
    with pytest.raises(RuntimeError, match="fused_mlp_block: an input requires grad"):
        tbf.fused_mlp_block(x, mlp[0], mlp[1], w, *mlp[3:])
    with pytest.raises(RuntimeError, match="fused_topk"):
        fused_topk(torch.zeros(8, 16), torch.zeros(1, 16, requires_grad=True), 0, 8, 2)
    with torch.no_grad():  # outside grad mode the wrappers run
        tbf.fused_mlp_block(x, mlp[0], mlp[1], w, *mlp[3:])
    tbf.fused_attn_block(x, *attn, n_heads=4)  # nothing requires grad


def test_differentiable_blocks_never_come_back_detached():
    """The kernel route of block_apply and fused_block_apply goes through
    FusedBlockFunction under grad (here on the CPU, its plain versions), and
    its gradients equal the plain route's; without grad it runs forward only."""
    p = params_from_numpy(tclip.init_clip_params(0, tiny_cfg()))["visual"]["blocks"][1]
    x0 = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 5, 64)).astype(np.float32))
    grads = {}
    for impl in ("kernel", "plain"):
        x = x0.clone().requires_grad_()
        out = tbf.fused_block_apply(x, p, 4, impl=impl)
        assert isinstance(out.grad_fn, torch.autograd.function.BackwardCFunction)
        out.square().sum().backward()
        grads[impl] = x.grad
    torch.testing.assert_close(grads["kernel"], grads["plain"], rtol=0, atol=0)
    x = x0.clone().requires_grad_()
    assert block_apply(x, p, 4, attn_impl="auto").grad_fn is not None
    with torch.no_grad():
        assert tbf.fused_block_apply(x, p, 4).grad_fn is None


def test_trainer_needs_a_card_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(tiny_cfg(), tclip.init_clip_params(0, tiny_cfg()), TrainConfig())
