"""The trainer's levers over a mesh in the port, held to the JAX package:
GradCache over several slots (``tests/test_gradcache.py::
test_gradcache_on_mesh_matches_single_device``: the chunks are of the
global batch), Muon and gradient accumulation under FSDP (the JAX trainer
composes both with ``fsdp``). Each against the JAX package's one-device
step (JAX's own tests hold its mesh and FSDP steps to that one:
``tests/test_{gradcache,fsdp,muon}.py``; compiling them here would cost
2.5 times as much) and against the port's own data-parallel or one-device
step: GradCache at JAX's tolerances (loss 1e-4, params rtol
2e-4 / atol 2e-5); FSDP's updates bit-equal to data parallelism's (the
same whole-matrix arithmetic, each slot taking its shard), and against
JAX as ``tests/test_torch_{muon,levers}.py`` hold a step (5e-3 relative,
Muon leaves by cosine, ``MUON_JAX_COS``)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from evr_tpu.training import TrainConfig as JTrainConfig
from evr_tpu.training import make_optimizer as j_make_optimizer
from evr_tpu.training import make_train_step as j_make_train_step
from evr_tpu.training.finetune import TrainState as JTrainState
from evr_tpu_torch.models.convert import params_from_numpy
from evr_tpu_torch.parallel import get_mesh
from evr_tpu_torch.parallel.fsdp import ShardedTensor, fsdp_state_shardings, gather_tree, shard_tree
from evr_tpu_torch.training import TrainConfig, TrainState, Trainer, make_grad_fn, make_optimizer, make_train_step

from torch_trainer_twins import (
    JCLS, TCLS, TOL, assert_close_rel, cfgs, np_params, tiny_batch, to_np, updates,
)
from torch_threads import one_torch_thread  # noqa: F401

GC = dict(batch_size=8, epochs=2, gradcache_chunks=2, compute_dtype="float32")
STEP = dict(lr=1e-3, batch_size=8, epochs=2, compute_dtype="float32", freeze_layers=8)
MUON = dict(STEP, optimizer="muon")
# A Muon leaf's update against the JAX package's one-device step: bf16
# Newton–Schulz carries the two packages' sum orders to the update (ROADMAP
# watch-list); about twice the measured gap (0.99918 least cosine of the
# port's FSDP step over 4 slots against JAX's one-device step, lr 1e-3, 12
# leaves; the port's data-parallel and one-device steps read the same)
MUON_JAX_COS = 0.9984
ACCUM = dict(STEP, grad_accumulation_steps=2)


def _jax_run(tc_kw, batches):
    """The JAX package's one-device steps → (metrics per step, flat params
    after each step)."""
    tc = JTrainConfig(**tc_kw)
    p = jax.tree.map(jnp.asarray, np_params())
    opt = j_make_optimizer(tc, p)
    state = JTrainState(params=p, opt_state=opt.init(p), step=jnp.zeros((), jnp.int32))
    step, _ = j_make_train_step(cfgs()[0], JCLS, tc, opt)
    ms, after = [], []
    for i, b in enumerate(batches):
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()}, jax.random.PRNGKey(i))
        ms.append({k: float(v) for k, v in m.items()})
        after.append(to_np(state.params))
    return ms, after


def _port_run(tc_kw, batches, slots=None, fsdp=False):
    """The port's steps on one device (``slots`` None), data-parallel over
    ``slots`` CPU slots, or FSDP over them → (metrics, flat params after
    each step, the state)."""
    tc = TrainConfig(**tc_kw)
    p = params_from_numpy(np_params())
    opt = make_optimizer(tc, p)
    mesh = None if slots is None else get_mesh(slots, device="cpu")
    sh = None
    if fsdp:
        sh = fsdp_state_shardings(p, opt, mesh, min_size=256)
        state = TrainState(params=shard_tree(p, sh.params), opt_state=shard_tree(opt.init(p), sh.opt_state), step=0)
    else:
        state = TrainState(params=p, opt_state=opt.init(p), step=0)
    step, _ = make_train_step(cfgs()[1], TCLS, tc, opt, mesh=mesh, state_shardings=sh)
    ms, after = [], []
    for b in batches:
        state, m = step(state, b)
        ms.append({k: float(v) for k, v in m.items()})
        after.append(to_np(gather_tree(state.params)))
    return ms, after, state


@pytest.fixture(scope="module")
def gradcache_jax():
    batch = tiny_batch(np.random.default_rng(2))
    return batch, _jax_run(GC, [batch])


@pytest.mark.parametrize("slots", [2, 4, 8])
def test_gradcache_on_mesh_matches_single_device(gradcache_jax, slots):
    """Two chunks of the global batch of 8 over 2, 4 and 8 slots (a chunk
    held by one slot, by two, by four): the step equals the JAX package's
    GradCache step and the port's one-device one."""
    batch, (jm, jp) = gradcache_jax
    (m1,), (p1,), _ = _port_run(GC, [batch])
    (mm,), (pm,), _ = _port_run(GC, [batch], slots)
    for ref_m, ref_p in ((jm[0], jp[0]), (m1, p1)):
        assert abs(mm["total_loss"] - ref_m["total_loss"]) < 1e-4
        for k in ref_p:
            np.testing.assert_allclose(pm[k], ref_p[k], rtol=2e-4, atol=2e-5, err_msg=k)


def test_gradcache_mesh_gradients_equal_the_direct_mesh_step():
    """The chunked gradients over 4 slots against the direct gradients over
    4 slots: only the order of sums moves (1e-4 relative)."""
    params = np_params()
    batch = tiny_batch(np.random.default_rng(1))
    mesh = get_mesh(4, device="cpu")
    dev = torch.device("cpu")
    md, gd = make_grad_fn(cfgs()[1], TCLS, TrainConfig(**dict(GC, gradcache_chunks=0)), mesh)(
        {dev: params_from_numpy(params)}, batch)
    mc, gc = make_grad_fn(cfgs()[1], TCLS, TrainConfig(**dict(GC, gradcache_chunks=4)), mesh)(
        {dev: params_from_numpy(params)}, batch)
    assert set(gc) == set(gd) and abs(float(mc["total_loss"]) - float(md["total_loss"])) < 1e-5
    assert assert_close_rel(to_np(gc), to_np(gd), 1e-4, "chunked vs direct over 4 slots") > 20
    with pytest.raises(ValueError, match="not divisible"):
        make_grad_fn(cfgs()[1], TCLS, TrainConfig(**dict(GC, gradcache_chunks=3)), mesh)(
            {dev: params_from_numpy(params)}, batch)


@pytest.fixture(scope="module")
def muon_runs():
    batches = [tiny_batch(np.random.default_rng(4 + i)) for i in range(2)]
    return (batches, _jax_run(MUON, batches[:1]),
            _port_run(MUON, batches, 4), _port_run(MUON, batches, 4, fsdp=True))


def test_muon_under_fsdp_equals_data_parallel(muon_runs):
    """Two Muon steps under FSDP over 4 slots: every param bit-equal to the
    data-parallel steps (the Newton–Schulz of the whole gathered matrix,
    each slot taking its shard), the momentum split as its params."""
    _, _, (dm, dp, _), (fm, fp, state) = muon_runs
    for s in range(2):
        assert fm[s]["total_loss"] == dm[s]["total_loss"]
        for k in dp[s]:
            np.testing.assert_array_equal(fp[s][k], dp[s][k], err_msg=k)
    mom = state.opt_state["momentum"]["clip/visual/blocks/1/mlp/fc/kernel"]
    assert isinstance(mom, ShardedTensor) and mom.sharding.dim is not None


def test_muon_under_fsdp_matches_jax(muon_runs):
    """Against the JAX package's Muon step: the loss 1e-5, the AdamW
    leaves' updates 5e-3, the Muon leaves' updates by cosine
    (``MUON_JAX_COS``), every Muon leaf moved."""
    _, (jm, jp), _, (fm, fp, _) = muon_runs
    before = to_np(params_from_numpy(np_params()))
    labels = make_optimizer(TrainConfig(**MUON), params_from_numpy(np_params())).labels
    muon_keys = [k for k, lab in labels.items() if lab.endswith(":muon")]
    adam_keys = [k for k, lab in labels.items() if lab != "frozen" and k not in muon_keys]
    np.testing.assert_allclose(fm[0]["total_loss"], jm[0]["total_loss"], rtol=1e-5)
    ut, uj = updates(fp[0], before), updates(jp[0], before)
    assert assert_close_rel(ut, uj, TOL, "fsdp muon", keys=adam_keys) > 10
    assert len(muon_keys) == 12
    for k in muon_keys:
        cos = float((ut[k] * uj[k]).sum() / (np.linalg.norm(ut[k]) * np.linalg.norm(uj[k])))
        assert cos >= MUON_JAX_COS and ut[k].any(), (k, cos)


@pytest.fixture(scope="module")
def accumulation_runs():
    batches = [tiny_batch(np.random.default_rng(7 + i)) for i in range(2)]
    return (batches, _jax_run(ACCUM, batches),
            _port_run(ACCUM, batches, 4), _port_run(ACCUM, batches, 4, fsdp=True))


def test_accumulation_under_fsdp_equals_data_parallel(accumulation_runs):
    """Two calls at ``grad_accumulation_steps=2`` under FSDP over 4 slots:
    call 1 leaves the params bit-still, and every call's params are
    bit-equal to the data-parallel run's; the accumulator is split as its
    params and reset after the update."""
    _, _, (dm, dp, _), (fm, fp, state) = accumulation_runs
    before = to_np(params_from_numpy(np_params()))
    for k in before:
        np.testing.assert_array_equal(fp[0][k], before[k], err_msg=k)
    for s in range(2):
        assert fm[s]["total_loss"] == dm[s]["total_loss"]
        for k in dp[s]:
            np.testing.assert_array_equal(fp[s][k], dp[s][k], err_msg=k)
    acc = state.opt_state["acc_grads"]["clip/text/token_embedding"]
    assert isinstance(acc, ShardedTensor) and acc.sharding.spec == ("data", None)
    assert state.opt_state["gradient_step"] == 1 and not acc.full().any()


def test_accumulation_under_fsdp_matches_jax(accumulation_runs):
    """Against the JAX package's accumulation: the losses of both calls
    and the emitting call's updates within 5e-3."""
    _, (jm, jp), _, (fm, fp, _) = accumulation_runs
    before = to_np(params_from_numpy(np_params()))
    for s in range(2):
        np.testing.assert_allclose(fm[s]["total_loss"], jm[s]["total_loss"], rtol=TOL)
    assert assert_close_rel(updates(fp[1], before), updates(jp[1], before), TOL, "call 2") > 10


def test_trainer_fsdp_takes_muon_and_accumulation(tmp_path):
    """``Trainer(fsdp=True)`` builds with Muon and with accumulation (both
    refused before) and an epoch equals the data-parallel trainer's."""
    batches = [tiny_batch(np.random.default_rng(20 + i)) for i in range(2)]
    for kw in (dict(optimizer="muon"), dict(grad_accumulation_steps=2)):
        out = []
        for fsdp in (False, True):
            tc = TrainConfig(freeze_layers=0, lr=1e-3, epochs=1, batch_size=8, compute_dtype="float32",
                             save_dir=str(tmp_path / f"{fsdp}"), **kw)
            p = np_params()
            tr = Trainer(cfgs()[1], p["clip"], tc, classifier_params=p["classifier"], cls_cfg=TCLS, device="cpu",
                         mesh=get_mesh(2, device="cpu"), fsdp=fsdp, log_fn=lambda s: None)
            tr.fit(lambda e: iter(batches))
            out.append(to_np(tr._whole(tr.state.params)))
        for k in out[0]:
            np.testing.assert_array_equal(out[1][k], out[0][k], err_msg=(kw, k))
