"""Data-parallel fine-tuning in the port (``parallel.contrastive``'s global
losses, ``training.finetune.make_train_step(mesh=)``, ``Trainer(mesh=)``)
held to the JAX package's (``tests/test_parallel.py``,
``tests/test_siglip_loss.py::test_global_siglip_equals_single_device``,
``tests/test_multislice.py``), to the JAX package's mesh step (losses and
params after the step) and to the port's own one-device step on the
global batch, at the JAX tests' tolerances: losses and norms rtol 1e-5,
params after a step rtol 1e-4 / atol 1e-6 (``tests/test_fsdp.py:158-161``).
The port's CPU mesh lists the CPU in every slot; JAX runs on conftest's 8
host devices."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from evr_tpu.parallel import get_mesh as jget_mesh
from evr_tpu.parallel.contrastive import infonce_loss_single as jinfonce
from evr_tpu.parallel.contrastive import make_sharded_infonce as jmake_sharded_infonce
from evr_tpu.parallel.contrastive import siglip_loss_single as jsiglip
from evr_tpu.training import TrainConfig as JTrainConfig
from evr_tpu.training import make_optimizer as j_make_optimizer
from evr_tpu.training import make_train_step as j_make_train_step
from evr_tpu.training.finetune import TrainState as JTrainState
from evr_tpu_torch.models.classifier import ClassifierConfig
from evr_tpu_torch.models.convert import params_from_numpy
from evr_tpu_torch.parallel import get_mesh, get_multislice_mesh
from evr_tpu_torch.parallel.contrastive import (
    global_infonce_loss,
    global_siglip_loss,
    infonce_loss_single,
    make_sharded_infonce,
    siglip_loss_single,
    split_rows,
)
from evr_tpu_torch.training import TrainConfig, TrainState, Trainer, make_optimizer, make_train_step
from evr_tpu_torch.training.finetune import make_grad_fn
from evr_tpu_torch.training.losses import combined_clip_loss

from torch_trainer_twins import JCLS, TCLS, cfgs, np_params, tiny_batch, to_np
from torch_threads import one_torch_thread  # noqa: F401


def unit_rows(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def test_global_infonce_matches_single_device(rng):
    """``tests/test_parallel.py::test_global_infonce_matches_single_device``
    at 8 slots: the port's sharded loss equals both packages' single-device
    loss and JAX's sharded one."""
    B, D = 32, 32
    img, txt = unit_rows(rng, B, D), unit_rows(rng, B, D)
    scale = np.log(1 / 0.07).astype(np.float32)
    j_single = float(jinfonce(jnp.asarray(img), jnp.asarray(txt), jnp.asarray(scale)))
    j_sharded = float(jmake_sharded_infonce(jget_mesh(8))(jnp.asarray(img), jnp.asarray(txt), jnp.asarray(scale)))
    t_img, t_txt, t_scale = torch.from_numpy(img), torch.from_numpy(txt), torch.tensor(scale)
    t_single = float(infonce_loss_single(t_img, t_txt, t_scale))
    t_sharded = float(make_sharded_infonce(get_mesh(8, device="cpu"))(t_img, t_txt, t_scale))
    for got in (t_single, t_sharded, j_sharded):
        np.testing.assert_allclose(got, j_single, rtol=1e-5)


def test_global_losses_send_gradients_to_every_slot(rng):
    """The gathered features carry the gradient back to each slot: the
    per-slot feature gradients of the global InfoNCE and SigLIP losses are
    the rows of the single-device gradients, and so are the scale's and the
    bias's."""
    B, D = 16, 8
    img, txt = unit_rows(rng, B, D), unit_rows(rng, B, D)
    mesh = get_mesh(4, device="cpu")
    for name in ("infonce", "siglip"):
        ref = [torch.from_numpy(a).requires_grad_() for a in (img, txt)]
        scale = torch.tensor(2.3, requires_grad=True)
        bias = torch.tensor(-10.0, requires_grad=True)
        parts = [[p.detach().clone().requires_grad_() for p in split_rows(mesh, torch.from_numpy(a))]
                 for a in (img, txt)]
        s2, b2 = scale.detach().clone().requires_grad_(), bias.detach().clone().requires_grad_()
        if name == "infonce":
            single = infonce_loss_single(*ref, scale)
            glob = global_infonce_loss(*parts, s2, mesh)
        else:
            single = siglip_loss_single(*ref, scale, bias)
            glob = global_siglip_loss(*parts, s2, b2, mesh)
        np.testing.assert_allclose(float(glob.detach()), float(single.detach()), rtol=1e-6)
        single.backward()
        glob.backward()
        for r, ps in zip(ref, parts):
            np.testing.assert_allclose(torch.cat([p.grad for p in ps]).numpy(), r.grad.numpy(),
                                       rtol=1e-5, atol=1e-7, err_msg=name)
        np.testing.assert_allclose(float(s2.grad), float(scale.grad), rtol=1e-5)
        if name == "siglip":
            np.testing.assert_allclose(float(b2.grad), float(bias.grad), rtol=1e-5)


def test_global_siglip_equals_single_device():
    """``tests/test_siglip_loss.py::test_global_siglip_equals_single_device``:
    8 slots of 4 rows, the global loss within rel 1e-6 of the single one, in
    both packages."""
    rng = np.random.default_rng(2)
    B, D = 32, 16
    img, txt = unit_rows(rng, B, D), unit_rows(rng, B, D)
    scale, bias = np.log(10.0).astype(np.float32), np.float32(-10.0)
    j_single = float(jsiglip(jnp.asarray(img), jnp.asarray(txt), jnp.asarray(scale), bias))
    mesh = get_mesh(8, device="cpu")
    t = global_siglip_loss(split_rows(mesh, torch.from_numpy(img)), split_rows(mesh, torch.from_numpy(txt)),
                           torch.tensor(scale), torch.tensor(bias), mesh)
    assert float(t) == pytest.approx(j_single, rel=1e-6)


def test_combined_loss_over_slots_equals_one_batch(rng):
    """``combined_clip_loss`` with ``axis``: the contrastive, classification
    and accuracy terms of the global batch (slot means averaged)."""
    B, D = 16, 8
    mesh = get_mesh(4, device="cpu")
    img, txt = torch.from_numpy(unit_rows(rng, B, D)), torch.from_numpy(unit_rows(rng, B, D))
    logits = torch.from_numpy(rng.normal(size=(B, 3)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 3, size=B))
    scale = torch.tensor(2.0)
    for impl in ("infonce", "siglip"):
        _, single = combined_clip_loss(img, txt, scale, logits, labels, label_smoothing=0.1,
                                       contrastive_impl=impl)
        _, glob = combined_clip_loss(*(split_rows(mesh, x) for x in (img, txt)), scale,
                                     split_rows(mesh, logits), split_rows(mesh, labels),
                                     label_smoothing=0.1, contrastive_impl=impl, axis="data", mesh=mesh)
        for k, v in single.items():
            np.testing.assert_allclose(float(glob[k]), float(v), rtol=1e-6, err_msg=f"{impl} {k}")


def _steps(tc_kw, batch, mesh=None, slots=None, generator_seed=None, cls=TCLS, axis="data"):
    """One port step (and the eval step after it) → (metrics, eval metrics,
    flat params after)."""
    tc = TrainConfig(**tc_kw)
    p = params_from_numpy(np_params())
    opt = make_optimizer(tc, p)
    step, ev = make_train_step(cfgs()[1], cls, tc, opt, mesh=mesh, axis=axis)
    state = TrainState(params=p, opt_state=opt.init(p), step=0)
    gen = None if generator_seed is None else torch.Generator().manual_seed(generator_seed)
    state, m = step(state, batch, gen)
    e = ev(state, batch)
    return ({k: float(v) for k, v in m.items()}, {k: float(v) for k, v in e.items()}, to_np(state.params))


def _jax_mesh_step(tc_kw, batch, mesh):
    """One JAX mesh step from the same params → (metrics, flat params after)."""
    tc = JTrainConfig(**tc_kw)
    p = jax.tree.map(jnp.asarray, np_params())
    opt = j_make_optimizer(tc, p)
    step, _ = j_make_train_step(cfgs()[0], JCLS, tc, opt, mesh=mesh)
    state = JTrainState(params=p, opt_state=opt.init(p), step=jnp.zeros((), jnp.int32))
    state, m = step(state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    return {k: float(v) for k, v in m.items()}, to_np(state.params)


def _assert_params_close(got: dict, ref: dict):
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("freeze_layers", [0, 8])
def test_mesh_step_matches_one_device_step(freeze_layers):
    """The mesh step over 4 slots equals the one-device step on the global
    batch (losses, the eval step after the update, every param), frozen
    prefix or not, and the unfrozen step's losses and every param after it
    equal the JAX package's mesh step over 8 devices."""
    tc_kw = dict(freeze_layers=freeze_layers, lr=1e-4, batch_size=16, compute_dtype="float32")
    batch = tiny_batch(np.random.default_rng(1), 16)
    m1, e1, p1 = _steps(tc_kw, batch)
    m4, e4, p4 = _steps(tc_kw, batch, mesh=get_mesh(4, device="cpu"))
    for k in m1:
        np.testing.assert_allclose(m4[k], m1[k], rtol=1e-5, err_msg=k)
    for k in e1:
        np.testing.assert_allclose(e4[k], e1[k], rtol=1e-5, err_msg=k)
    _assert_params_close(p4, p1)
    if freeze_layers:
        return  # one JAX compile: the unfrozen step
    jm, jp = _jax_mesh_step(tc_kw, batch, jget_mesh(8))
    for k in ("contrastive_loss", "classification_loss", "total_loss"):
        np.testing.assert_allclose(m4[k], jm[k], rtol=1e-5, err_msg=k)
    _assert_params_close(p4, jp)


def test_mesh_step_draws_for_the_global_batch():
    """Patch drop and the classifier's dropout draw for the global batch in
    the one-device step's order, and each slot takes its rows: the same
    generator gives the same step over 4 slots as on one device."""
    tc_kw = dict(freeze_layers=0, lr=1e-4, batch_size=8, compute_dtype="float32", patch_drop=0.25)
    cls = ClassifierConfig(embed_dim=32, num_classes=3, dropout=0.3)
    batch = tiny_batch(np.random.default_rng(2), 8)
    m1, _, p1 = _steps(tc_kw, batch, generator_seed=5, cls=cls)
    m4, _, p4 = _steps(tc_kw, batch, mesh=get_mesh(4, device="cpu"), generator_seed=5, cls=cls)
    for k in m1:
        np.testing.assert_allclose(m4[k], m1[k], rtol=1e-5, err_msg=k)
    _assert_params_close(p4, p1)


def test_multislice_training_step(monkeypatch):
    """``tests/test_multislice.py``: rows over a (replica 2 × data 4) mesh,
    both axes jointly, give the single-device global-batch loss; the layout
    needs 8 slots. Over ``data`` alone the replica axis's slots share their
    group's rows, and the loss is the same."""
    monkeypatch.setenv("EVR_TPU_CPU_DEVICES", "8")
    mesh = get_multislice_mesh(2, 4, device="cpu")
    assert mesh.shape == {"replica": 2, "data": 4}
    with pytest.raises(ValueError):
        get_multislice_mesh(4, 4, device="cpu")
    tc_kw = dict(freeze_layers=0, lr=1e-4, compute_dtype="float32")
    batch = tiny_batch(np.random.default_rng(3), 16)
    m1, _, _ = _steps(tc_kw, batch)
    m8, _, _ = _steps(tc_kw, batch, mesh=mesh, axis=("replica", "data"))
    np.testing.assert_allclose(m8["contrastive_loss"], m1["contrastive_loss"], rtol=1e-5)
    assert mesh.leaders("data") == [0, 1, 2, 3] and mesh.leaders(("replica", "data")) == list(range(8))
    m4, _, p4 = _steps(tc_kw, batch, mesh=mesh, axis="data")
    np.testing.assert_allclose(m4["contrastive_loss"], m1["contrastive_loss"], rtol=1e-5)


def test_trainer_mesh_fit_equals_one_device_fit(tmp_path):
    """``Trainer(mesh=)``: two epochs of two batches give the one-device
    trainer's params and history; the checkpoints it writes restore."""
    batches = [tiny_batch(np.random.default_rng(10 + i), 8) for i in range(2)]
    out = {}
    for name, mesh in (("one", None), ("mesh", get_mesh(2, device="cpu"))):
        tc = TrainConfig(freeze_layers=0, lr=1e-4, epochs=2, batch_size=8, compute_dtype="float32",
                         save_dir=str(tmp_path / name))
        p = np_params()
        tr = Trainer(cfgs()[1], p["clip"], tc, classifier_params=p["classifier"], cls_cfg=TCLS,
                     device="cpu", mesh=mesh, log_fn=lambda s: None)
        res = tr.fit(lambda e: iter(batches), lambda e: iter(batches[:1]))
        out[name] = (res, to_np(tr.state.params))
        payload = tr.restore_checkpoint("final_checkpoint")
        assert payload["step"] == 4
    (r1, p1), (r2, p2) = out["one"], out["mesh"]
    for row1, row2 in zip(r1["history"], r2["history"]):
        np.testing.assert_allclose(row2["train_total_loss"], row1["train_total_loss"], rtol=1e-5)
        np.testing.assert_allclose(row2["val_total_loss"], row1["val_total_loss"], rtol=1e-5)
    _assert_params_close(p2, p1)


def test_mesh_refusals():
    """GradCache over a mesh and a mesh whose model axis holds slots (data
    parallelism over its data groups) run, each with the one-device loss;
    rows that do not split over the slots raise before a step."""
    mesh = get_mesh(4, device="cpu")
    batch = tiny_batch(np.random.default_rng(0), 8)
    dev = torch.device("cpu")
    ref = make_grad_fn(cfgs()[1], TCLS, TrainConfig(compute_dtype="float32"))(params_from_numpy(np_params()), batch)[0]
    for tc, m in ((TrainConfig(gradcache_chunks=2, compute_dtype="float32"), mesh),
                  (TrainConfig(compute_dtype="float32"), get_mesh(4, ("data", "model"), (2, 2), device="cpu"))):
        got = make_grad_fn(cfgs()[1], TCLS, tc, m)({dev: params_from_numpy(np_params())}, batch)[0]
        np.testing.assert_allclose(float(got["total_loss"]), float(ref["total_loss"]), rtol=1e-5)
    fn = make_grad_fn(cfgs()[1], TCLS, TrainConfig(compute_dtype="float32"), mesh)
    with pytest.raises(ValueError, match="do not split"):
        fn({torch.device("cpu"): params_from_numpy(np_params())}, tiny_batch(np.random.default_rng(0), 6))
