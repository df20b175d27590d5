"""Pipeline parallelism in the port (``evr_tpu_torch.parallel.pp``) held to
``tests/test_pp.py``: the pipelined vision and text encodes over 2 and 4
stages, dp × pp, the pre-split serving shape and gradients through the
pipeline, each against the JAX package's pipelined encode on conftest's
8 host devices and against the port's one-device encode, at the JAX
test's tolerances (embeddings 1e-5, gradients 2e-5). The stage-stacked
checkpoint is in ``tests/test_torch_sharded_ckpt.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evr_tpu.models.clip import CLIPConfig as JCLIPConfig
from evr_tpu.models.clip import TextConfig as JTextConfig
from evr_tpu.models.clip import VisionConfig as JVisionConfig
from evr_tpu.models.clip import init_clip_params as jinit_clip_params
from evr_tpu.parallel import pp as jpp
from evr_tpu.parallel.mesh import get_mesh as jget_mesh
from evr_tpu_torch.models.clip import CLIPConfig, TextConfig, VisionConfig, encode_image, encode_text
from evr_tpu_torch.models.convert import params_from_numpy
from evr_tpu_torch.parallel import get_mesh, pp

from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def setup():
    """``tests/test_pp.py``'s geometry and inputs; the JAX params carried
    across."""
    kw = dict(vision=dict(image_size=32, patch_size=8, width=64, layers=4, heads=4),
              text=dict(context_length=16, vocab_size=128, width=32, layers=4, heads=2), embed_dim=16)
    jcfg = JCLIPConfig(vision=JVisionConfig(**kw["vision"]), text=JTextConfig(**kw["text"]),
                       embed_dim=16, attn_impl="xla")
    cfg = CLIPConfig(vision=VisionConfig(**kw["vision"]), text=TextConfig(**kw["text"]), embed_dim=16,
                     attn_impl="xla")
    jparams = jinit_clip_params(jax.random.PRNGKey(0), jcfg)
    np_params = jax.tree.map(np.asarray, jparams)
    rng = np.random.default_rng(0)
    pixels = rng.normal(size=(8, 32, 32, 3)).astype(np.float32)
    toks = rng.integers(1, 126, (8, 16)).astype(np.int32)
    for b in range(8):
        toks[b, rng.integers(1, 16)] = 127
    return jcfg, cfg, jparams, np_params, pixels, toks


def _port(setup, **kw):
    _, cfg, _, np_params, pixels, toks = setup
    return cfg, params_from_numpy(np_params), torch.from_numpy(pixels), torch.from_numpy(toks).long()


def test_stack_unstack_roundtrip(setup):
    _, params, _, _ = _port(setup)
    blocks = params["visual"]["blocks"]
    stacked = pp.stack_blocks(blocks)
    np.testing.assert_array_equal(stacked["attn"]["qkv"]["kernel"].numpy(),
                                  np.asarray(jpp.stack_blocks(setup[2]["visual"]["blocks"])["attn"]["qkv"]["kernel"]))
    back = pp.unstack_blocks(stacked)
    assert len(back) == len(blocks)
    for a, b in zip(blocks, back):
        for k in ("ln_1", "ln_2"):
            assert torch.equal(a[k]["scale"], b[k]["scale"])
        assert torch.equal(a["mlp"]["proj"]["kernel"], b["mlp"]["proj"]["kernel"])


@pytest.mark.parametrize("stages,n_micro,data", [(4, 4, 1), (2, 8, 1), (4, 2, 2)],
                         ids=["4stage", "2stage-8micro", "dp2xpp4"])
def test_pipelined_image_encode_exact(setup, stages, n_micro, data):
    """Pure pp at 4 and 2 stages and dp × pp on a (data 2, stage 4) mesh,
    against JAX's pipelined encode and the port's one-device encode."""
    jcfg, _, jparams, _, _, _ = setup
    cfg, params, pixels, _ = _port(setup)
    if data == 1:
        jmesh, mesh = jget_mesh(stages, axis_names=("stage",)), get_mesh(stages, ("stage",), device="cpu")
        kw = {}
    else:
        jmesh = jget_mesh(data * stages, axis_names=("data", "stage"), shape=(data, stages))
        mesh = get_mesh(data * stages, ("data", "stage"), (data, stages), device="cpu")
        kw = {"data_axis": "data"}
    jout = np.asarray(jpp.make_pipelined_image_encode(jmesh, jcfg, n_micro=n_micro, **kw)(jparams, jnp.asarray(setup[4])))
    with torch.no_grad():
        out = pp.make_pipelined_image_encode(mesh, cfg, n_micro=n_micro, **kw)(params, pixels).numpy()
        ref = encode_image(params, cfg, pixels).numpy()
    np.testing.assert_allclose(out, jout, atol=1e-5)
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_pipelined_text_encode_exact(setup):
    jcfg, _, jparams, _, _, jtoks = setup
    cfg, params, _, toks = _port(setup)
    jout = np.asarray(jpp.make_pipelined_text_encode(jget_mesh(4, axis_names=("stage",)), jcfg, n_micro=4)(
        jparams, jnp.asarray(jtoks)))
    with torch.no_grad():
        out = pp.make_pipelined_text_encode(get_mesh(4, ("stage",), device="cpu"), cfg, n_micro=4)(params, toks)
        ref = encode_text(params, cfg, toks)
    np.testing.assert_allclose(out.numpy(), jout, atol=1e-5)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-5)


def test_uneven_stages_raises(setup):
    cfg, _, _, _ = _port(setup)
    with pytest.raises(ValueError, match="do not split evenly"):
        pp.make_pipelined_image_encode(get_mesh(3, ("stage",), device="cpu"), cfg, n_micro=4)


def test_grad_through_pipeline_matches_single_device(setup):
    """JAX's representative leaves (first and last stage blocks and the
    tail): the port's pipeline gradient against JAX's pipeline gradient and
    against the port's one-device gradient, at 2e-5."""
    jcfg, _, jparams, _, jpixels, _ = setup
    cfg, params, pixels, _ = _port(setup)
    jmesh = jget_mesh(4, axis_names=("stage",))
    jenc = jpp.make_pipelined_image_encode(jmesh, jcfg, n_micro=4)
    tgt = np.ones((8, cfg.embed_dim), np.float32)
    g_j = jax.grad(lambda p: jnp.mean((jenc(p, jnp.asarray(jpixels)) - tgt) ** 2))(jparams)
    enc = pp.make_pipelined_image_encode(get_mesh(4, ("stage",), device="cpu"), cfg, n_micro=4)

    def grads(fn):
        leaves = {k: v for k, v in _leaves(params)}
        for t in leaves.values():
            t.grad = None
            t.requires_grad_(True)
        loss = ((fn(params, pixels) - torch.from_numpy(tgt)) ** 2).mean()
        loss.backward()
        out = {k: t.grad.clone() for k, t in leaves.items() if t.grad is not None}
        for t in leaves.values():
            t.requires_grad_(False)
            t.grad = None
        return out

    g_pp = grads(enc)
    g_ref = grads(lambda p, x: encode_image(p, cfg, x))
    for path in (("visual", "blocks", 0, "attn", "qkv", "kernel"), ("visual", "blocks", 3, "mlp", "proj", "kernel"),
                 ("visual", "ln_post", "scale"), ("visual", "proj")):
        key = "/".join(map(str, path))
        a = g_j
        for k in path:
            a = a[k]
        np.testing.assert_allclose(g_pp[key].numpy(), np.asarray(a), atol=2e-5, err_msg=key)
        np.testing.assert_allclose(g_pp[key].numpy(), g_ref[key].numpy(), atol=2e-5, err_msg=key)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (i,))
    else:
        yield "/".join(map(str, prefix)), tree


def test_presplit_encode_exact(setup):
    """The serving shape: ``stage_params`` places the stacks once; the
    pre-split encoders equal JAX's and the one-device encodes, and a second
    call reuses the unstacked blocks."""
    jcfg, _, jparams, _, jpixels, jtoks = setup
    cfg, params, pixels, toks = _port(setup)
    jmesh, mesh = jget_mesh(4, axis_names=("stage",)), get_mesh(4, ("stage",), device="cpu")
    jrest, jv, jt = jpp.stage_params(jmesh, jparams)
    rest, v_stacked, t_stacked = pp.stage_params(mesh, params)
    enc_i = pp.make_pipelined_image_encode(mesh, cfg, n_micro=4, presplit=True)
    enc_t = pp.make_pipelined_text_encode(mesh, cfg, n_micro=4, presplit=True)
    with torch.no_grad():
        img, txt = enc_i(rest, v_stacked, pixels), enc_t(rest, t_stacked, toks)
        again = enc_i(rest, v_stacked, pixels)
        ref_i, ref_t = encode_image(params, cfg, pixels), encode_text(params, cfg, toks)
    j_img = np.asarray(jpp.make_pipelined_image_encode(jmesh, jcfg, n_micro=4, presplit=True)(
        jrest, jv, jnp.asarray(jpixels)))
    j_txt = np.asarray(jpp.make_pipelined_text_encode(jmesh, jcfg, n_micro=4, presplit=True)(
        jrest, jt, jnp.asarray(jtoks)))
    np.testing.assert_allclose(img.numpy(), j_img, atol=1e-5)
    np.testing.assert_allclose(txt.numpy(), j_txt, atol=1e-5)
    np.testing.assert_allclose(img.numpy(), ref_i.numpy(), atol=1e-5)
    np.testing.assert_allclose(txt.numpy(), ref_t.numpy(), atol=1e-5)
    assert torch.equal(again, img)


def test_stage_params_placement(setup):
    cfg, params, _, _ = _port(setup)
    rest, v_stacked, t_stacked = pp.stage_params(get_mesh(4, ("stage",), device="cpu"), params)
    leaf = v_stacked["attn"]["qkv"]["kernel"]
    assert leaf.shape[0] == cfg.vision.layers
    assert leaf.sharding.shard_shape(leaf.shape)[0] == cfg.vision.layers // 4
    assert [s.shape[0] for s in leaf.shards] == [1, 1, 1, 1]
    assert rest["visual"]["blocks"] == () and rest["text"]["blocks"] == ()
    assert torch.equal(leaf.full(), pp.stack_blocks(params["visual"]["blocks"])["attn"]["qkv"]["kernel"])
