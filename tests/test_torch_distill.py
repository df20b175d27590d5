"""The port's distillation (``training.distill``, ``tools.distill``)
against ``evr_tpu`` on the CPU.

The KD and alignment losses and their gradients against JAX's (1e-6 /
1e-5); two ``DistillationTrainer`` steps from the same seeded student and
teacher (the tiny geometry of ``tests/torch_trainer_twins.py`` as the
student, a wider, deeper teacher of the same embed dim), fp32, all three
terms on: losses 1e-5, every student leaf's update 5e-3 relative L2, the
teacher bit-still; the CLI end to end, its ``student.pt`` served; the
refusals.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from evr_tpu.models.clip import CLIPConfig as JCLIPConfig
from evr_tpu.models.clip import TextConfig as JTextConfig
from evr_tpu.models.clip import VisionConfig as JVisionConfig
from evr_tpu.training import distill as jd
from evr_tpu_torch.index.engine import EmbeddingEngine, load_torch_checkpoint
from evr_tpu_torch.models.clip import CLIPConfig, TextConfig, VisionConfig, init_clip_params
from evr_tpu_torch.models.convert import params_from_numpy
from evr_tpu_torch.tools import distill as cli
from evr_tpu_torch.training import distill as td

from torch_trainer_twins import assert_close_rel, cfgs, tiny_batch, to_np, updates

TEACHER = dict(vision=dict(image_size=32, patch_size=8, width=128, layers=3, heads=4),
               text=dict(context_length=16, vocab_size=600, width=128, layers=3, heads=4))


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def test_kd_loss_is_zero_when_the_student_is_the_teacher():
    rng = np.random.default_rng(0)
    img, txt = (torch.from_numpy(_unit(rng, 6, 16)) for _ in range(2))
    assert abs(td.similarity_kd_loss(img, txt, img, txt).item()) < 1e-6
    assert abs(td.embed_align_loss(img, img).item()) < 1e-6
    other = torch.from_numpy(_unit(rng, 6, 24))  # the teacher's width may differ
    assert td.similarity_kd_loss(img, txt, other, torch.from_numpy(_unit(rng, 6, 24))).item() > 0


@pytest.mark.parametrize("temperature", [1.0, 2.0, 4.0])
def test_kd_and_align_losses_and_gradients_match_jax(temperature):
    rng = np.random.default_rng(1)
    s_img, s_txt = _unit(rng, 8, 16), _unit(rng, 8, 16)
    t_img, t_txt = _unit(rng, 8, 24), _unit(rng, 8, 24)
    a_img = _unit(rng, 8, 16)

    def jloss(si, st):
        return (jd.similarity_kd_loss(si, st, jnp.asarray(t_img), jnp.asarray(t_txt), temperature)
                + jd.embed_align_loss(si, jnp.asarray(a_img)))

    jval, jg = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(s_img), jnp.asarray(s_txt))
    si, st = (torch.tensor(a, requires_grad=True) for a in (s_img, s_txt))
    tval = (td.similarity_kd_loss(si, st, torch.from_numpy(t_img), torch.from_numpy(t_txt), temperature)
            + td.embed_align_loss(si, torch.from_numpy(a_img)))
    tval.backward()
    np.testing.assert_allclose(tval.item(), float(jval), rtol=1e-6)
    np.testing.assert_allclose(si.grad.numpy(), np.asarray(jg[0]), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(jg[1]), rtol=1e-5, atol=1e-7)


def test_two_steps_match_jax_and_the_teacher_stays_still():
    jcfg, tcfg = cfgs("auto")
    jt_cfg = JCLIPConfig(embed_dim=32, vision=JVisionConfig(**TEACHER["vision"]), text=JTextConfig(**TEACHER["text"]))
    tt_cfg = CLIPConfig(embed_dim=32, vision=VisionConfig(**TEACHER["vision"]), text=TextConfig(**TEACHER["text"]))
    student, teacher = init_clip_params(0, tcfg), init_clip_params(1, tt_cfg)
    kw = dict(lr=1e-3, compute_dtype="float32", align_weight=0.5)
    jtr = jd.DistillationTrainer(jcfg, jax.tree.map(jnp.asarray, student), jt_cfg,
                                 jax.tree.map(jnp.asarray, teacher), jd.DistillConfig(**kw))
    ttr = td.DistillationTrainer(tcfg, student, tt_cfg, teacher, td.DistillConfig(**kw), device="cpu")
    assert ttr.student_cfg.attn_impl == "auto_grad" and ttr.teacher_cfg.attn_impl == "auto"
    teacher_before = to_np(ttr.teacher_params)
    rng = np.random.default_rng(2)
    for s in range(2):
        b = tiny_batch(rng)
        b = {"images": b["images"], "tokens": b["tokens"]}
        before_t, before_j = to_np(ttr.params), to_np(jtr.params)
        jm, tm = jtr.train_step(b), ttr.train_step(b)
        assert set(tm) == set(jm) and {"kd_loss", "align_loss", "total_loss"} <= set(tm)
        for k in jm:
            np.testing.assert_allclose(tm[k], jm[k], rtol=1e-5, atol=1e-7, err_msg=f"{k} @ {s}")
        moved = assert_close_rel(updates(to_np(ttr.params), before_t), updates(to_np(jtr.params), before_j),
                                 what=f"step {s}")
        assert moved >= len(before_t) - 1  # every leaf (the key bias's key third is rounding noise)
    assert all(np.array_equal(v, teacher_before[k]) for k, v in to_np(ttr.teacher_params).items())
    assert not any(t.requires_grad for t in ttr.teacher_params["visual"]["blocks"][0]["attn"]["qkv"].values())


def test_embed_dim_mismatch_is_refused_for_the_alignment_term():
    _, tcfg = cfgs()
    teacher_cfg = CLIPConfig(embed_dim=48, vision=VisionConfig(**TEACHER["vision"]),
                             text=TextConfig(**TEACHER["text"]))
    with pytest.raises(ValueError, match="align_weight needs matching embed dims"):
        td.DistillationTrainer(tcfg, init_clip_params(0, tcfg), teacher_cfg, init_clip_params(1, teacher_cfg),
                               td.DistillConfig(align_weight=0.1), device="cpu")
    # the KD term alone takes different embed dims
    td.DistillationTrainer(tcfg, init_clip_params(0, tcfg), teacher_cfg, init_clip_params(1, teacher_cfg),
                           device="cpu")


def _caption_set(root, n, size):
    import cv2

    rng = np.random.default_rng(3)
    meta = {}
    for i in range(n):
        cv2.imwrite(str(root / f"img{i}.jpg"), (rng.random((size, size, 3)) * 255).astype(np.uint8))
        meta[f"img{i}.jpg"] = {"caption": f"a red car number {i}", "category": "NonViolence"}
    path = root / "caps.json"
    path.write_text(json.dumps(meta))
    return path


def test_cli_writes_a_student_pt_that_serves(tmp_path, capsys):
    js = _caption_set(tmp_path, 8, 64)
    save = tmp_path / "out"
    history = cli.main(["--train-json", str(js), "--data-dir", str(tmp_path), "--student-model", "ViT-Tiny-Test",
                        "--teacher-model", "ViT-Tiny-Test", "--epochs", "2", "--batch-size", "4",
                        "--save-dir", str(save), "--device", "cpu", "--seed", "3"])
    out = capsys.readouterr().out
    assert "train=8 student=ViT-Tiny-Test" in out and "WARNING: no --teacher-checkpoint" in out
    assert len(history) == 2 and all(np.isfinite(h["kd_loss"]) for h in history)
    assert json.loads((save / "history.json").read_text()) == history
    payload = torch.load(save / "student.pt", weights_only=True)
    assert payload["step"] == 2 and payload["epoch"] == 1 and set(payload["params"]) == {"clip"}
    blob = load_torch_checkpoint(save / "student.pt")
    assert blob["classifier"] is None
    engine = EmbeddingEngine.from_checkpoint(save / "student.pt", "ViT-Tiny-Test", device="cpu", batch_size=4)
    in_memory = EmbeddingEngine("ViT-Tiny-Test", params=payload["params"]["clip"], device="cpu", batch_size=4)
    seeded = EmbeddingEngine("ViT-Tiny-Test", params=init_clip_params(3, in_memory.cfg), device="cpu", batch_size=4)
    staged = np.random.default_rng(4).integers(0, 256, (3, 64, 64, 3), dtype=np.uint8)
    got = engine.encode_staged_images(staged)
    assert np.array_equal(got, in_memory.encode_staged_images(staged))
    assert not np.array_equal(got, seeded.encode_staged_images(staged))  # the student trained


def test_sizes_that_differ_are_refused_as_the_jax_cli_refuses(tmp_path, capsys, monkeypatch):
    """The JAX CLI's defaults (a ViT-L/14@336px teacher, a ViT-B/32 student)
    refuse: the towers must share a pixel size. Both packages refuse a
    ViT-B/32 teacher for a ViT-Tiny-Test student with the same message; the
    port also refuses its own defaults."""
    import evr_tpu.models
    import evr_tpu.training.distill
    from evr_tpu.tools import distill as jcli

    # the JAX CLI draws both towers and builds its trainer before it
    # checks the sizes: stand-ins for those two keep the test fast
    monkeypatch.setattr(evr_tpu.models, "init_clip_params", lambda rng, cfg: {})
    monkeypatch.setattr(evr_tpu.training.distill, "DistillationTrainer", lambda *a, **k: None)
    js = _caption_set(tmp_path, 2, 64)
    common = ["--train-json", str(js), "--data-dir", str(tmp_path), "--save-dir", str(tmp_path / "o")]
    pair = ["--student-model", "ViT-Tiny-Test", "--teacher-model", "ViT-B/32"]
    with pytest.raises(SystemExit) as jerr:
        jcli.main(common + pair)
    with pytest.raises(SystemExit) as terr:
        cli.main(common + pair + ["--device", "cpu"])
    assert str(terr.value) == str(jerr.value) == (
        "student image_size 64 != teacher 224: pick a teacher at the student's resolution "
        "(e.g. ViT-L/14 for a 224px student)")
    with pytest.raises(SystemExit, match="student image_size 224 != teacher 336"):
        cli.main(common + ["--device", "cpu"])
    capsys.readouterr()
