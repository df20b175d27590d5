"""FSDP in the port (``evr_tpu_torch.parallel.fsdp``, ``Trainer(fsdp=True)``,
``tools.finetune --fsdp``) held to ``tests/test_fsdp.py``: the same sharding
rule as the JAX package's, each slot holding its slice of the large leaves,
and a step that is a layout change only: equal to the one-device step on the
global batch and to the JAX package's FSDP step at the JAX test's tolerances (losses rtol 1e-5, params rtol
1e-4 / atol 1e-6), with and without a frozen prefix."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from evr_tpu.parallel import get_mesh as jget_mesh
from evr_tpu.parallel.fsdp import fsdp_spec as jfsdp_spec
from evr_tpu.parallel.fsdp import fsdp_state_shardings as jfsdp_state_shardings
from evr_tpu.parallel.fsdp import shard_tree as jshard_tree
from evr_tpu.training import TrainConfig as JTrainConfig
from evr_tpu.training import make_optimizer as j_make_optimizer
from evr_tpu.training import make_train_step as j_make_train_step
from evr_tpu.training.finetune import TrainState as JTrainState
from evr_tpu_torch.models.convert import params_from_numpy
from evr_tpu_torch.parallel import get_mesh
from evr_tpu_torch.parallel.fsdp import (
    ShardedTensor,
    fsdp_shardings,
    fsdp_spec,
    fsdp_state_shardings,
    gather_tree,
    shard_tree,
    sharded_bytes_per_device,
)
from evr_tpu_torch.training import TrainConfig, TrainState, Trainer, make_optimizer, make_train_step

from torch_trainer_twins import JCLS, TCLS, cfgs, np_params, tiny_batch, to_np
from torch_threads import one_torch_thread  # noqa: F401


def _jspec(spec: tuple) -> P:
    return P(*spec)


def test_fsdp_spec_rule():
    """``tests/test_fsdp.py::test_fsdp_spec_rule``, case by case against the
    JAX package's rule."""
    n = 8
    cases = [((512, 128), 256), ((256, 256), 256), ((17, 65), 2), ((8,), 256), ((), 2**14),
             ((600, 64), 256), ((3, 1024, 16), 2**14)]
    for shape, min_size in cases:
        assert _jspec(fsdp_spec(shape, "data", n, min_size)) == jfsdp_spec(shape, "data", n, min_size), shape
    assert fsdp_spec((512, 128), "data", n, 256) == ("data", None)
    assert fsdp_spec((256, 256), "data", n, 256) == (None, "data")
    assert fsdp_spec((17, 65), "data", n, 2) == ()


def test_fsdp_state_shards_on_slots():
    """``tests/test_fsdp.py::test_fsdp_state_shards_on_devices``: the token
    embedding (600, 64) splits by rows, 75 a slot over 8; slot 0 holds well
    under half of the whole state (params and AdamW moments); the shardings
    of every leaf match the JAX package's."""
    mesh = get_mesh(8, device="cpu")
    params = params_from_numpy(np_params())
    tc = TrainConfig(freeze_layers=0, batch_size=16, compute_dtype="float32")
    opt = make_optimizer(tc, params)
    sh = fsdp_state_shardings(params, opt, mesh, min_size=256)
    state = TrainState(params=shard_tree(params, sh.params),
                       opt_state=shard_tree(opt.init(params), sh.opt_state), step=0)
    emb = state.params["clip"]["text"]["token_embedding"]
    assert isinstance(emb, ShardedTensor) and emb.sharding.spec == ("data", None)
    assert emb.shards[0].shape == (600 // 8, 64) and len(emb.shards) == 8
    total = sum(t.numel() * t.element_size() for t in _tensors((params, opt.init(params))))
    per_slot = sharded_bytes_per_device((state.params, state.opt_state))
    assert per_slot < 0.45 * total, (per_slot, total)
    jmesh = jget_mesh(8)
    jparams = jax.tree.map(jnp.asarray, np_params())
    jsh = jfsdp_state_shardings(jparams, j_make_optimizer(JTrainConfig(freeze_layers=0), jparams), jmesh,
                                min_size=256)
    for path, s in _leaves(sh.params):
        j = _at(jsh.params, path)
        assert _jspec(s.spec) == j.spec, path


def _tensors(tree):
    return [leaf for _, leaf in _leaves(tree) if isinstance(leaf, torch.Tensor)]


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (i,))
    else:
        yield prefix, tree


def _at(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _fsdp_step(tc_kw, batch, slots):
    tc = TrainConfig(**tc_kw)
    p = params_from_numpy(np_params())
    opt = make_optimizer(tc, p)
    if slots is None:
        state = TrainState(params=p, opt_state=opt.init(p), step=0)
        step, ev = make_train_step(cfgs()[1], TCLS, tc, opt)
    else:
        mesh = get_mesh(slots, device="cpu")
        sh = fsdp_state_shardings(p, opt, mesh, min_size=256)
        state = TrainState(params=shard_tree(p, sh.params), opt_state=shard_tree(opt.init(p), sh.opt_state),
                           step=0)
        step, ev = make_train_step(cfgs()[1], TCLS, tc, opt, mesh=mesh, state_shardings=sh)
    state, m = step(state, batch)
    e = ev(state, batch)
    return ({k: float(v) for k, v in m.items()}, {k: float(v) for k, v in e.items()},
            to_np(gather_tree(state.params)), state)


def _jax_fsdp_step(tc_kw, batch):
    """The JAX package's FSDP step over conftest's 8 host devices → (metrics,
    flat params after)."""
    tc = JTrainConfig(**tc_kw)
    p = jax.tree.map(jnp.asarray, np_params())
    opt = j_make_optimizer(tc, p)
    mesh = jget_mesh(8)
    sh = jfsdp_state_shardings(p, opt, mesh, min_size=256)
    state = JTrainState(params=jshard_tree(p, sh.params), opt_state=jshard_tree(opt.init(p), sh.opt_state),
                        step=jnp.zeros((), jnp.int32))
    step, _ = j_make_train_step(cfgs()[0], JCLS, tc, opt, mesh=mesh, state_shardings=sh)
    state, m = step(state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    return {k: float(v) for k, v in m.items()}, to_np(state.params)


@pytest.mark.parametrize("freeze_layers", [0, 8])
def test_fsdp_step_matches_single_device(freeze_layers):
    """``tests/test_fsdp.py::test_fsdp_step_matches_single_device``: one FSDP
    step over 8 slots equals the one-device step (train and eval losses,
    every param after the update); the unfrozen one also equals the JAX
    package's FSDP step over 8 devices (losses and every param after it)."""
    tc_kw = dict(freeze_layers=freeze_layers, lr=1e-4, batch_size=16, compute_dtype="float32")
    batch = tiny_batch(np.random.default_rng(4), 16)
    m1, e1, p1, _ = _fsdp_step(tc_kw, batch, None)
    m8, e8, p8, state = _fsdp_step(tc_kw, batch, 8)
    for k in m1:
        np.testing.assert_allclose(m8[k], m1[k], rtol=1e-5, err_msg=k)
    for k in e1:
        np.testing.assert_allclose(e8[k], e1[k], rtol=1e-5, err_msg=k)
    for k in p1:
        np.testing.assert_allclose(p8[k], p1[k], rtol=1e-4, atol=1e-6, err_msg=k)
    # the moments stayed in their shards
    mu = state.opt_state["mu"]["clip/text/token_embedding"]
    assert isinstance(mu, ShardedTensor) and mu.shards[0].shape == (75, 64)
    if freeze_layers:
        return  # one JAX compile: the unfrozen step
    jm, jp = _jax_fsdp_step(tc_kw, batch)
    for k in ("contrastive_loss", "classification_loss", "total_loss"):
        np.testing.assert_allclose(m8[k], jm[k], rtol=1e-5, err_msg=k)
    for k in jp:
        np.testing.assert_allclose(p8[k], jp[k], rtol=1e-4, atol=1e-6, err_msg=k)


def test_fsdp_shardings_on_meta_tensors():
    """``tests/test_fsdp.py::test_fsdp_shardings_on_shape_structs``: planning
    takes meta tensors (nothing allocated)."""
    mesh = get_mesh(8, device="cpu")
    shapes = {"w": torch.empty((1024, 64), device="meta"), "b": torch.empty((64,), device="meta")}
    sh = fsdp_shardings(shapes, mesh, min_size=256)
    assert sh["w"].spec == ("data", None) and sh["b"].spec == ()
    assert sh["w"].shard_shape((1024, 64)) == (128, 64)


def test_trainer_fsdp_fit_and_resume(tmp_path):
    """``tests/test_fsdp.py::test_trainer_fsdp_fit``: ``Trainer(mesh,
    fsdp=True)`` shards the live state, fits with finite losses and the
    one-device trainer's params, writes whole checkpoints, and a restore
    puts each slot's slice back."""
    batches = [tiny_batch(np.random.default_rng(20 + i), 8) for i in range(2)]
    out = {}
    for name, kw in (("one", {}), ("fsdp", dict(mesh=get_mesh(4, device="cpu"), fsdp=True))):
        tc = TrainConfig(freeze_layers=0, lr=1e-4, epochs=1, batch_size=8, compute_dtype="float32",
                         save_dir=str(tmp_path / name), ema_decay=0.9)
        p = np_params()
        tr = Trainer(cfgs()[1], p["clip"], tc, classifier_params=p["classifier"], cls_cfg=TCLS,
                     device="cpu", log_fn=lambda s: None, **kw)
        res = tr.fit(lambda e: iter(batches))
        assert np.isfinite(res["history"][-1]["train_total_loss"])
        out[name] = (to_np(gather_tree(tr.state.params)), to_np(gather_tree(tr.state.ema_params)), tr)
    for a, b in ((out["fsdp"][0], out["one"][0]), (out["fsdp"][1], out["one"][1])):
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, atol=1e-6, err_msg=k)
    tr = out["fsdp"][2]
    emb = tr.state.params["clip"]["text"]["token_embedding"]
    assert emb.sharding.spec == ("data", None) and emb.shards[0].shape[0] == 600 // 4
    payload = torch.load(tmp_path / "fsdp" / "final_checkpoint.pt", weights_only=True)
    assert payload["params"]["clip"]["text"]["token_embedding"].shape == (600, 64)
    before = to_np(gather_tree(tr.state.params))
    tr.restore_checkpoint("final_checkpoint")
    assert isinstance(tr.state.params["clip"]["text"]["token_embedding"], ShardedTensor)
    after = to_np(gather_tree(tr.state.params))
    for k in before:
        np.testing.assert_array_equal(after[k], before[k], err_msg=k)


def test_fsdp_refusals():
    """The JAX trainer's refusals (FSDP without a mesh; with an ``expert``
    axis) and the port's (with a ``model`` axis: one state layout); Muon and
    gradient accumulation under FSDP build, their moments, momentum and
    accumulator split as their params."""
    p = np_params()
    tcfg = cfgs()[1]
    with pytest.raises(ValueError, match="requires a mesh"):
        Trainer(tcfg, p["clip"], TrainConfig(), device="cpu", fsdp=True)
    with pytest.raises(ValueError, match="expert"):
        Trainer(tcfg, p["clip"], TrainConfig(), fsdp=True,
                mesh=get_mesh(4, ("data", "expert"), (2, 2), device="cpu"))
    with pytest.raises(ValueError, match="model"):
        Trainer(tcfg, p["clip"], TrainConfig(), fsdp=True,
                mesh=get_mesh(4, ("data", "model"), (2, 2), device="cpu"))
    for kw, key in ((dict(optimizer="muon"), "momentum"), (dict(grad_accumulation_steps=2), "acc_grads")):
        tr = Trainer(tcfg, p["clip"], TrainConfig(compute_dtype="float32", freeze_layers=0, **kw), fsdp=True,
                     mesh=get_mesh(2, device="cpu"), log_fn=lambda s: None)
        leaf = tr.state.opt_state[key]["clip/text/token_embedding" if key == "acc_grads" else
                                       "clip/visual/blocks/1/mlp/fc/kernel"]
        assert isinstance(leaf, ShardedTensor) and len(leaf.shards) == 2


def test_cli_fsdp_runs(tmp_path, monkeypatch, capsys):
    """``tools.finetune --fsdp`` over the default mesh (``EVR_TPU_CPU_DEVICES``
    CPU slots) trains and writes its checkpoints; ``--fsdp --no-mesh``
    refuses as the JAX trainer does."""
    from PIL import Image

    from evr_tpu_torch.tools import finetune as cli

    rng = np.random.default_rng(0)
    caps = {}
    for i in range(10):
        name = f"f{i}.jpg"
        Image.fromarray((rng.random((48, 48, 3)) * 255).astype(np.uint8)).save(tmp_path / name)
        caps[name] = {"caption": f"frame {i}", "category": ["Violence", "NonViolence"][i % 2]}
    (tmp_path / "caps.json").write_text(json.dumps(caps))
    monkeypatch.setenv("EVR_TPU_CPU_DEVICES", "2")
    argv = ["--train-json", str(tmp_path / "caps.json"), "--data-dir", str(tmp_path), "--model", "ViT-Tiny-Test",
            "--device", "cpu", "--batch-size", "4", "--epochs", "1", "--freeze-layers", "0",
            "--save-dir", str(tmp_path / "ck"), "--fsdp"]
    result = cli.main(argv)
    assert "mesh {'data': 2} over 1 process(es), fsdp" in capsys.readouterr().out
    assert result["history"][0]["train_batches"] == 2 and np.isfinite(result["history"][0]["train_total_loss"])
    assert (tmp_path / "ck" / "final_checkpoint.pt").exists()
    with pytest.raises(ValueError, match="requires a mesh"):
        cli.main(argv + ["--no-mesh"])
