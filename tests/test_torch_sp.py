"""Sequence parallelism in the port (``evr_tpu_torch.parallel.sp``) held to
``tests/test_sp.py``: token-sharded vision encodes over 2, 3 and 4 ``seq``
slots (T = 17 padded), the causal text tower (global row ids, ragged
shards), dp × sp and gradients, each against the JAX package's sp encode
on conftest's 8 host devices and the port's one-device encode, at the JAX
test's tolerances (embeddings 1e-5, gradients 2e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evr_tpu.models.clip import CLIPConfig as JCLIPConfig
from evr_tpu.models.clip import TextConfig as JTextConfig
from evr_tpu.models.clip import VisionConfig as JVisionConfig
from evr_tpu.models.clip import init_clip_params as jinit_clip_params
from evr_tpu.parallel import sp as jsp
from evr_tpu.parallel.mesh import get_mesh as jget_mesh
from evr_tpu_torch.models.clip import CLIPConfig, TextConfig, VisionConfig, encode_image, encode_text
from evr_tpu_torch.models.convert import params_from_numpy
from evr_tpu_torch.parallel import get_mesh, sp

from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def setup():
    """``tests/test_sp.py``'s geometry and inputs; the JAX params carried
    across."""
    v = dict(image_size=32, patch_size=8, width=64, layers=3, heads=4)
    t = dict(context_length=16, vocab_size=128, width=32, layers=2, heads=2)
    jcfg = JCLIPConfig(vision=JVisionConfig(**v), text=JTextConfig(**t), embed_dim=16, attn_impl="xla")
    cfg = CLIPConfig(vision=VisionConfig(**v), text=TextConfig(**t), embed_dim=16, attn_impl="xla")
    jparams = jinit_clip_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)
    pixels = rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
    toks = rng.integers(1, 126, (4, 16)).astype(np.int32)
    for b in range(4):
        toks[b, rng.integers(1, 16)] = 127
    params = params_from_numpy(jax.tree.map(np.asarray, jparams))
    return jcfg, cfg, jparams, params, pixels, toks


def _meshes(n, data=1):
    if data == 1:
        return jget_mesh(n, axis_names=("seq",)), get_mesh(n, ("seq",), device="cpu"), {}
    return (jget_mesh(n * data, axis_names=("data", "seq"), shape=(data, n)),
            get_mesh(n * data, ("data", "seq"), (data, n), device="cpu"), {"data_axis": "data"})


@pytest.mark.parametrize("n,data", [(2, 1), (4, 1), (4, 2)], ids=["2way-padded", "4way", "dp2xsp4"])
def test_sp_image_encode_exact(setup, n, data):
    """T = 17 over 2 slots pads to 18 (padded key columns never reach real
    rows), over 4 to 20; dp × sp on a (data 2, seq 4) mesh."""
    jcfg, cfg, jparams, params, pixels, _ = setup
    jmesh, mesh, kw = _meshes(n, data)
    jout = np.asarray(jsp.make_sp_image_encode(jmesh, jcfg, **kw)(jparams, jnp.asarray(pixels)))
    with torch.no_grad():
        out = sp.make_sp_image_encode(mesh, cfg, **kw)(params, torch.from_numpy(pixels)).numpy()
        ref = encode_image(params, cfg, torch.from_numpy(pixels)).numpy()
    np.testing.assert_allclose(out, jout, atol=1e-5)
    np.testing.assert_allclose(out, ref, atol=1e-5)


@pytest.mark.parametrize("n", [4, 3], ids=["4way", "ragged3"])
def test_sp_text_encode_causal_exact(setup, n):
    """The causal tower by global row id; context 16 over 3 slots pads to 18
    (causal and padding masks compose)."""
    jcfg, cfg, jparams, params, _, toks = setup
    jmesh, mesh, _ = _meshes(n)
    jout = np.asarray(jsp.make_sp_text_encode(jmesh, jcfg)(jparams, jnp.asarray(toks)))
    with torch.no_grad():
        out = sp.make_sp_text_encode(mesh, cfg)(params, torch.from_numpy(toks)).numpy()
        ref = encode_text(params, cfg, torch.from_numpy(toks).long()).numpy()
    np.testing.assert_allclose(out, jout, atol=1e-5)
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_sp_grad_exact(setup):
    """JAX's representative leaves: the sp gradient against JAX's sp
    gradient and the port's one-device gradient, at 2e-5."""
    jcfg, cfg, jparams, params, pixels, _ = setup
    jmesh, mesh, _ = _meshes(2)
    tgt = np.ones((4, cfg.embed_dim), np.float32)
    jenc = jsp.make_sp_image_encode(jmesh, jcfg)
    g_j = jax.grad(lambda p: jnp.mean((jenc(p, jnp.asarray(pixels)) - tgt) ** 2))(jparams)
    paths = (("visual", "blocks", 0, "attn", "qkv", "kernel"), ("visual", "blocks", 2, "mlp", "fc", "kernel"),
             ("visual", "patch_embed", "kernel"))

    def leaf(tree, path):
        for k in path:
            tree = tree[k]
        return tree

    def grads(fn):
        ts = [leaf(params, p) for p in paths]
        for t in ts:
            t.requires_grad_(True)
        out = torch.autograd.grad(((fn(params, torch.from_numpy(pixels)) - torch.from_numpy(tgt)) ** 2).mean(), ts)
        for t in ts:
            t.requires_grad_(False)
        return out

    g_sp = grads(sp.make_sp_image_encode(mesh, cfg))
    g_ref = grads(lambda p, x: encode_image(p, cfg, x))
    for path, a, b in zip(paths, g_sp, g_ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(leaf(g_j, path)), atol=2e-5, err_msg=str(path))
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5, err_msg=str(path))


def test_sp_attention_pads_and_masks(setup):
    """``_pad_tokens`` pads the token axis to a multiple of the slots, and a
    block over token shards equals ``block_apply`` on the whole sequence."""
    from evr_tpu_torch.models.layers import block_apply

    _, cfg, _, params, _, _ = setup
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 17, 64)).astype(np.float32))
    assert sp._pad_tokens(x, 4).shape == (2, 20, 64) and sp._pad_tokens(x, 17).shape == (2, 17, 64)
    p = params["visual"]["blocks"][0]
    padded = sp._pad_tokens(x, 4)
    with torch.no_grad():
        got = torch.cat(sp.sp_block_apply(list(padded.split(5, dim=1)), [p] * 4, 4, False, 17), dim=1)[:, :17]
        want = block_apply(x, p, 4, False, "xla")
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
