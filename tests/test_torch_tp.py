"""Tensor parallelism in the port (``evr_tpu_torch.parallel.tp``, the
``("data", "model")`` step and ``Trainer(mesh=)``) held to
``tests/test_tp.py``: the JAX rule's shardings leaf for leaf, dp × tp steps
over (data 2, model 2), (data 4, model 2) and (data 1, model 2) equal, loss
and every leaf, to the JAX package's dp × tp step over (data 2, model 2) of
conftest's host devices and to the port's one-device step at the JAX test's
tolerances (loss rtol 1e-5, params rtol 1e-4 / atol 1e-6), each model slot
holding its column or row shard."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from evr_tpu.parallel import get_mesh as jget_mesh
from evr_tpu.parallel.tp import clip_param_shardings as jclip_param_shardings
from evr_tpu.training import TrainConfig as JTrainConfig
from evr_tpu.training import make_optimizer as j_make_optimizer
from evr_tpu.training import make_train_step as j_make_train_step
from evr_tpu.training.finetune import TrainState as JTrainState
from evr_tpu_torch.models.convert import params_from_numpy
from evr_tpu_torch.parallel import get_mesh
from evr_tpu_torch.parallel.fsdp import ShardedTensor, gather_tree, shard_tree, sharded_bytes_per_device
from evr_tpu_torch.parallel.tp import clip_param_shardings, tp_state_shardings
from evr_tpu_torch.training import TrainConfig, TrainState, Trainer, make_optimizer, make_train_step

from torch_trainer_twins import JCLS, TCLS, cfgs, np_params, tiny_batch, to_np
from torch_threads import one_torch_thread  # noqa: F401

TC = dict(freeze_layers=0, lr=1e-4, compute_dtype="float32")
FC = "clip/visual/blocks/0/mlp/fc/kernel"


def _walk(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, prefix + (i,))
    else:
        yield prefix, tree


def _at(tree, path):
    for p in path:
        tree = tree[p]
    return tree


@pytest.fixture(scope="module")
def jax_tp_step():
    """``tests/test_tp.py``'s dp × tp step, over (data 2, model 2): (metrics,
    flat params after, the fc kernel's sharding spec)."""
    mesh = jget_mesh(4, axis_names=("data", "model"), shape=(2, 2))
    params = jax.tree.map(jnp.asarray, np_params())
    tc = JTrainConfig(**TC)
    shardings = jclip_param_shardings(mesh, params)
    p = jax.tree.map(lambda a, s: jax.device_put(np.array(a), s), params, shardings)
    opt = j_make_optimizer(tc, params)
    step, _ = j_make_train_step(cfgs()[0], JCLS, tc, opt)
    state = JTrainState(params=p, opt_state=opt.init(p), step=jnp.zeros((), jnp.int32))
    batch = {k: jax.device_put(v, NamedSharding(mesh, P("data"))) for k, v in tiny_batch(np.random.default_rng(0)).items()}
    state, m = step(state, batch, jax.random.PRNGKey(0))
    spec = state.params["clip"]["visual"]["blocks"][0]["mlp"]["fc"]["kernel"].sharding.spec
    return {k: float(v) for k, v in m.items()}, to_np(state.params), spec


def _port_step(shape, tc_kw=TC, steps=1):
    """(metrics per step, flat params after, the state) of the port's step:
    one device (``shape`` None) or tensor parallel over ``("data",
    "model")`` of ``shape``."""
    tc = TrainConfig(**tc_kw)
    p = params_from_numpy(np_params())
    opt = make_optimizer(tc, p)
    batches = [tiny_batch(np.random.default_rng(i)) for i in range(steps)]
    if shape is None:
        state = TrainState(params=p, opt_state=opt.init(p), step=0)
        step, _ = make_train_step(cfgs()[1], TCLS, tc, opt)
    else:
        mesh = get_mesh(shape[0] * shape[1], ("data", "model"), shape, device="cpu")
        sh = tp_state_shardings(p, opt, mesh)
        state = TrainState(params=shard_tree(p, sh.params), opt_state=shard_tree(opt.init(p), sh.opt_state), step=0)
        step, _ = make_train_step(cfgs()[1], TCLS, tc, opt, mesh=mesh, state_shardings=sh)
    ms = []
    for b in batches:
        state, m = step(state, b)
        ms.append({k: float(v) for k, v in m.items()})
    return ms, to_np(gather_tree(state.params)), state


def test_clip_param_shardings_rule():
    """Every leaf's spec equals the JAX rule's: qkv and fc kernels by column,
    their biases with them, out and proj kernels by row, the rest
    replicated."""
    params = np_params()
    jmesh = jget_mesh(8, axis_names=("data", "model"), shape=(4, 2))
    js = jclip_param_shardings(jmesh, jax.tree.map(jnp.asarray, params))
    ts = clip_param_shardings(get_mesh(8, ("data", "model"), (4, 2), device="cpu"), params_from_numpy(params))
    n = 0
    for path, s in _walk(ts):
        assert P(*s.spec) == _at(js, path).spec, path
        n += bool(s.spec)
    assert n == 4 * 6  # four blocks, six split leaves each
    assert _at(ts, ("clip", "visual", "blocks", 0, "attn", "qkv", "kernel")).spec == (None, "model")
    assert _at(ts, ("clip", "text", "blocks", 1, "mlp", "proj", "kernel")).spec == ("model", None)


@pytest.mark.parametrize("shape", [(2, 2), (4, 2), (1, 2)], ids=["dp2xtp2", "dp4xtp2", "tp2"])
def test_tp_sharded_step_matches_single(jax_tp_step, shape):
    """``tests/test_tp.py::test_tp_sharded_step_matches_single``: the port's
    step over the mesh against the JAX package's dp × tp step over (data 2,
    model 2) and the port's one-device step, the losses and every leaf
    (the column-split qkv and fc kernels, whose qkv shards cut across
    heads, and the row-split out and proj kernels among them); the fc
    kernel split over ``model``."""
    jm, jp, jspec = jax_tp_step
    (m1,), p1, _ = _port_step(None)
    (mt,), pt, state = _port_step(shape)
    for ref in (jm, m1):
        for name in ("total_loss", "contrastive_loss"):
            np.testing.assert_allclose(mt[name], ref[name], rtol=1e-5, err_msg=name)
    assert set(jp) == set(p1) == set(pt)
    for ref in (jp, p1):
        for k in ref:
            np.testing.assert_allclose(pt[k], ref[k], rtol=1e-4, atol=1e-6, err_msg=k)
    fc = state.params["clip"]["visual"]["blocks"][0]["mlp"]["fc"]["kernel"]
    assert jspec == P(None, "model") and fc.sharding.spec == (None, "model")
    assert [tuple(s.shape) for s in fc.shards] == [(64, 128)] * (shape[0] * shape[1])
    mu = state.opt_state["mu"][FC]
    assert isinstance(mu, ShardedTensor) and mu.sharding.spec == (None, "model")


def test_tp_steps_with_frozen_prefix_and_bytes():
    """Two steps with a frozen prefix over (data 2, model 2) equal the
    one-device steps; a slot holds the split leaves' halves, under the
    replicated state's bytes."""
    kw = dict(TC, freeze_layers=8)
    m1, p1, _ = _port_step(None, kw, steps=2)
    mt, pt, state = _port_step((2, 2), kw, steps=2)
    for a, b in zip(mt, m1):
        np.testing.assert_allclose(a["total_loss"], b["total_loss"], rtol=1e-5)
    for k in p1:
        np.testing.assert_allclose(pt[k], p1[k], rtol=1e-4, atol=1e-6, err_msg=k)
    whole = sum(v.nbytes for v in p1.values())
    slot = sharded_bytes_per_device(state.params)
    assert slot < 0.8 * whole, (slot, whole)


def test_trainer_on_a_model_axis(tmp_path):
    """``Trainer(mesh=<data 2 × model 2>)``: the state is split over
    ``model``; an epoch equals the one-device trainer's; its checkpoint
    restores into the split layout."""
    batches = [tiny_batch(np.random.default_rng(10 + i)) for i in range(2)]
    out = {}
    for name, mesh in (("one", None), ("tp", get_mesh(4, ("data", "model"), (2, 2), device="cpu"))):
        tc = TrainConfig(freeze_layers=0, lr=1e-4, epochs=1, batch_size=8, compute_dtype="float32",
                         save_dir=str(tmp_path / name))
        p = np_params()
        tr = Trainer(cfgs()[1], p["clip"], tc, classifier_params=p["classifier"], cls_cfg=TCLS, device="cpu",
                     mesh=mesh, log_fn=lambda s: None)
        res = tr.fit(lambda e: iter(batches))
        out[name] = (res, to_np(tr._whole(tr.state.params)))
        if mesh is not None:
            assert isinstance(tr.state.params["clip"]["visual"]["blocks"][0]["attn"]["qkv"]["kernel"], ShardedTensor)
            before = out[name][1]
            tr.restore_checkpoint("final_checkpoint")
            assert tr.state.params["clip"]["visual"]["blocks"][0]["attn"]["out"]["kernel"].sharding.spec == \
                ("model", None)
            after = to_np(tr._whole(tr.state.params))
            for k in before:
                np.testing.assert_array_equal(after[k], before[k], err_msg=k)
    (r1, p1), (r2, p2) = out["one"], out["tp"]
    np.testing.assert_allclose(r2["history"][0]["train_total_loss"], r1["history"][0]["train_total_loss"],
                               rtol=1e-5)
    for k in p1:
        np.testing.assert_allclose(p2[k], p1[k], rtol=1e-4, atol=1e-6, err_msg=k)
    with pytest.raises(ValueError, match="model"):
        Trainer(cfgs()[1], np_params()["clip"], TrainConfig(), device="cpu", fsdp=True,
                mesh=get_mesh(4, ("data", "model"), (2, 2), device="cpu"))


def test_blocks_gather_where_they_run():
    """The step's view of a tensor-parallel tree: the split block leaves stay
    shards until their block runs, then come back whole (column shards
    joined in model order)."""
    from evr_tpu_torch.parallel.tp import lazy_aliases, lazy_tree

    mesh = get_mesh(4, ("data", "model"), (2, 2), device="cpu")
    p = params_from_numpy(np_params())
    tree = params_from_numpy(np_params(), shardings=clip_param_shardings(mesh, p))
    assert isinstance(tree["clip"]["text"]["blocks"][1]["attn"]["qkv"]["kernel"], ShardedTensor)
    view = lazy_tree(tree, torch.device("cpu"), "data")
    assert isinstance(view["clip"]["visual"]["blocks"][0]["mlp"]["fc"]["kernel"], ShardedTensor)
    assert isinstance(view["clip"]["visual"]["proj"], torch.Tensor)
    aliases, registry = lazy_aliases(view, torch.device("cpu"), lambda key: True)
    assert FC not in registry
    block = aliases["clip"]["visual"]["blocks"][0]
    assert torch.equal(block["mlp"]["fc"]["kernel"], p["clip"]["visual"]["blocks"][0]["mlp"]["fc"]["kernel"])
    assert registry[FC].requires_grad and aliases["clip"]["visual"]["blocks"][0] is block
