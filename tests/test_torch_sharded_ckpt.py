"""Sharded checkpoints in the port (``evr_tpu_torch.training.sharded_ckpt``)
held to ``tests/test_sharded_ckpt.py``'s contract for the data-parallel and
FSDP trees: a tree saved shard by shard from 4 slots restores bit for bit
onto 2 slots, 1 slot or a data-parallel (whole) layout; params, AdamW
moments and the step round-trip; an overwrite is crash-safe; a template tree
serves as the target. The JAX package writes orbax (JAX only), so the
port's format is its own and is compared with the tree it saved. The
tensor-parallel trees (``parallel.tp.clip_param_shardings`` over a (data 4,
model 2) mesh) round-trip with their placement and restore replicated and
over model 4; the stage-stacked trees (``parallel.pp.stage_params``)
round-trip with theirs."""

import json

import numpy as np
import pytest
import torch

from evr_tpu_torch.models.clip import CLIPConfig, TextConfig, VisionConfig, init_clip_params
from evr_tpu_torch.models.convert import params_from_numpy
from evr_tpu_torch.parallel import get_mesh
from evr_tpu_torch.parallel.fsdp import ShardedTensor, fsdp_shardings, fsdp_state_shardings, gather_tree, shard_tree
from evr_tpu_torch.parallel import pp
from evr_tpu_torch.parallel.mesh import Sharding
from evr_tpu_torch.parallel.tp import clip_param_shardings
from evr_tpu_torch.training import TrainConfig, make_optimizer
from evr_tpu_torch.training.finetune import flat_leaves
from evr_tpu_torch.training.sharded_ckpt import (
    restore_sharded,
    restore_train_state_sharded,
    save_sharded,
    save_train_state_sharded,
)
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def small_params():
    """``tests/test_sharded_ckpt.py``'s geometry."""
    cfg = CLIPConfig(
        vision=VisionConfig(image_size=32, patch_size=8, width=64, layers=4, heads=4),
        text=TextConfig(context_length=16, vocab_size=128, width=32, layers=4, heads=2),
        embed_dim=16,
    )
    return cfg, params_from_numpy(init_clip_params(0, cfg))


def _assert_trees_equal(got, ref):
    g, r = flat_leaves(gather_tree(got)), flat_leaves(gather_tree(ref))
    assert g.keys() == r.keys()
    for k in r:
        if isinstance(r[k], torch.Tensor):
            assert g[k].dtype == r[k].dtype, k
            assert torch.equal(g[k], r[k]), k
        else:
            assert g[k] == r[k], k


def test_cross_topology_restore(small_params, tmp_path):
    """Saved from 4 slots, restored onto 2, 1 and 3 slots and as whole
    tensors: the checkpoint is topology-free, and each slot holds its slice
    of the new layout."""
    _, params = small_params
    saved = shard_tree(params, fsdp_shardings(params, get_mesh(4, device="cpu"), min_size=256))
    save_sharded(tmp_path / "ckpt", saved)
    files = sorted(p.name for p in (tmp_path / "ckpt").iterdir())
    assert files == ["index.json", "replicated.pt", "slot-0.pt", "slot-1.pt", "slot-2.pt", "slot-3.pt"]
    for n in (2, 1, 3):
        mesh = get_mesh(n, device="cpu")
        restored = restore_sharded(tmp_path / "ckpt", fsdp_shardings(params, mesh, min_size=256))
        _assert_trees_equal(restored, params)
        leaf = restored["visual"]["blocks"][0]["mlp"]["fc"]["kernel"]
        assert len(leaf.shards) == n
        assert leaf.shards[0].shape == leaf.sharding.shard_shape(leaf.shape)
    whole = restore_sharded(tmp_path / "ckpt", params)
    _assert_trees_equal(whole, params)
    assert isinstance(whole["visual"]["proj"], torch.Tensor)


def test_train_state_roundtrip(small_params, tmp_path):
    """params + AdamW moments + step through the TrainState helpers; the
    moments keep their params' shardings."""
    _, params = small_params
    tree = {"clip": params}
    mesh = get_mesh(4, device="cpu")
    opt = make_optimizer(TrainConfig(freeze_layers=0), tree)
    sh = fsdp_state_shardings(tree, opt, mesh, min_size=256)
    opt_state = opt.init(tree)
    gen = torch.Generator().manual_seed(0)
    for moments in (opt_state["mu"], opt_state["nu"]):
        for k in moments:
            moments[k] = torch.rand(moments[k].shape, generator=gen)
    opt_state["count"] = 3
    p_sh, o_sh = shard_tree(tree, sh.params), shard_tree(opt_state, sh.opt_state)
    save_train_state_sharded(tmp_path / "st", p_sh, o_sh, 7)
    p2, o2, step = restore_train_state_sharded(tmp_path / "st", sh.params, sh.opt_state)
    _assert_trees_equal(p2, tree)
    _assert_trees_equal(o2, opt_state)
    assert step == 7 and o2["count"] == 3
    mu = o2["mu"]["clip/text/token_embedding"]
    assert isinstance(mu, ShardedTensor) and mu.sharding.spec == sh.opt_state["mu"]["clip/text/token_embedding"].spec


def test_overwrite_is_crash_safe(tmp_path):
    """The old checkpoint survives until the new one is written whole; a
    complete ``.tmp`` left by a crash in the swap window restores."""
    mesh = get_mesh(2, device="cpu")
    rep = Sharding(mesh, ())
    tree1 = {"w": shard_tree(torch.ones((4, 4)), rep)}
    tree2 = {"w": shard_tree(torch.full((4, 4), 2.0), rep)}
    save_sharded(tmp_path / "c", tree1)
    save_sharded(tmp_path / "c", tree2)
    got = restore_sharded(tmp_path / "c", {"w": rep})
    np.testing.assert_array_equal(got["w"].full().numpy(), np.full((4, 4), 2.0))
    assert not (tmp_path / "c.tmp").exists()
    (tmp_path / "c").rename(tmp_path / "c.tmp")
    got = restore_sharded(tmp_path / "c", {"w": rep})
    np.testing.assert_array_equal(got["w"].full().numpy(), np.full((4, 4), 2.0))
    assert json.loads((tmp_path / "c.tmp" / "index.json").read_text())["w"]["shards"] == 1


def test_template_array_target(small_params, tmp_path):
    """A tree of live ``ShardedTensor``s serves as the target: the restore
    takes their shardings; a data-parallel (whole) tree restores into a
    sharded template too."""
    _, params = small_params
    sharded = shard_tree(params, fsdp_shardings(params, get_mesh(4, device="cpu"), min_size=256))
    save_sharded(tmp_path / "ckpt", sharded)
    restored = restore_sharded(tmp_path / "ckpt", sharded)
    _assert_trees_equal(restored, params)
    a = restored["text"]["blocks"][0]["attn"]["qkv"]["kernel"]
    b = sharded["text"]["blocks"][0]["attn"]["qkv"]["kernel"]
    assert a.sharding == b.sharding and a.shards[1].shape == b.shards[1].shape
    save_sharded(tmp_path / "dp", params)  # whole tensors, as data parallelism holds them
    _assert_trees_equal(restore_sharded(tmp_path / "dp", sharded), params)


def test_tp_sharded_roundtrip(small_params, tmp_path):
    """``tests/test_sharded_ckpt.py::test_tp_sharded_roundtrip``: a (data 4,
    model 2) tree saves each model shard once (two files, the data replicas
    not written again) and restores bit-equal with its placement."""
    _, params = small_params
    mesh = get_mesh(8, ("data", "model"), (4, 2), device="cpu")
    shardings = clip_param_shardings(mesh, params)
    save_sharded(tmp_path / "ckpt", shard_tree(params, shardings))
    files = sorted(p.name for p in (tmp_path / "ckpt").iterdir())
    assert files == ["index.json", "replicated.pt", "slot-0.pt", "slot-1.pt"]
    restored = restore_sharded(tmp_path / "ckpt", shardings)
    _assert_trees_equal(restored, params)
    leaf = restored["visual"]["blocks"][0]["attn"]["qkv"]["kernel"]
    assert leaf.sharding.spec == (None, "model")
    assert leaf.sharding.shard_shape(leaf.shape)[1] == leaf.shape[1] // 2
    assert [tuple(t.shape) for t in leaf.shards] == [(64, 96)] * 8
    assert torch.equal(leaf.shards[3], params["visual"]["blocks"][0]["attn"]["qkv"]["kernel"][:, 96:])


def test_cross_topology_restore_tp(small_params, tmp_path):
    """``tests/test_sharded_ckpt.py::test_cross_topology_restore``'s tensor-
    parallel case: saved over model 2, restored replicated over a data mesh
    and over (data 2, model 4), bit-equal both times."""
    _, params = small_params
    mesh2 = get_mesh(8, ("data", "model"), (4, 2), device="cpu")
    save_sharded(tmp_path / "ckpt", shard_tree(params, clip_param_shardings(mesh2, params)))
    rep = Sharding(get_mesh(8, device="cpu"), ())
    _assert_trees_equal(restore_sharded(tmp_path / "ckpt", map_tree(params, lambda _: rep)), params)
    mesh4 = get_mesh(8, ("data", "model"), (2, 4), device="cpu")
    restored = restore_sharded(tmp_path / "ckpt", clip_param_shardings(mesh4, params))
    _assert_trees_equal(restored, params)
    leaf = restored["visual"]["blocks"][0]["mlp"]["fc"]["kernel"]
    assert leaf.sharding.shard_shape(leaf.shape)[1] == leaf.shape[1] // 4 == leaf.shards[5].shape[1]


def test_pp_stage_sharded_roundtrip(small_params, tmp_path):
    """``tests/test_sharded_ckpt.py::test_pp_stage_sharded_roundtrip``: the
    stage-stacked vision blocks save and restore with their stage
    placement, bit-equal to the stacked blocks."""
    _, params = small_params
    mesh = get_mesh(4, ("stage",), device="cpu")
    _, v_stacked, _ = pp.stage_params(mesh, params)
    save_sharded(tmp_path / "v", v_stacked)
    restored = restore_sharded(tmp_path / "v", pp.stage_shardings(mesh, v_stacked))
    _assert_trees_equal(restored, pp.stack_blocks(params["visual"]["blocks"]))
    leaf = restored["attn"]["qkv"]["kernel"]
    assert leaf.sharding.shard_shape(leaf.shape)[0] == leaf.shape[0] // 4 == leaf.shards[2].shape[0]


def map_tree(tree, fn):
    if isinstance(tree, dict):
        return {k: map_tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_tree(v, fn) for v in tree]
    return fn(tree)
