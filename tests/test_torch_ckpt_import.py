"""The port's checkpoint import (``models/torch_import.py``) against the JAX
package's, on the CPU.

Both packages read the same state dicts and files; every leaf of the port's
tree must equal the JAX package's bit for bit (same dtype, shape and
values). The HF layout is held on a random-init ``transformers.CLIPModel``
(the geometry of ``tests/test_model_parity.py``), and the port's towers over
the converted params against HF's own outputs at 1e-5 in fp32.
"""

import numpy as np
import pytest
import torch

import jax

from evr_tpu.models import ClassifierConfig as JClassifierConfig
from evr_tpu.models import init_classifier_params as jinit_classifier
from evr_tpu.models import init_clip_params as jinit_clip
from evr_tpu.models import torch_export as jexport
from evr_tpu.models import torch_import as jimport
from evr_tpu_torch.models import clip as tclip
from evr_tpu_torch.models import params_from_numpy
from evr_tpu_torch.models import torch_import as timport

HF_TOL = 1e-5


def small_cfg(module):
    return module.CLIPConfig(
        embed_dim=32,
        vision=module.VisionConfig(image_size=32, patch_size=8, width=64, layers=2, heads=4),
        text=module.TextConfig(context_length=16, vocab_size=1000, width=64, layers=2, heads=4),
    )


def flat(tree, prefix=""):
    """{path: numpy leaf} of a nested dict/list tree."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in flat(sub, f"{prefix}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in flat(sub, f"{prefix}/{i}").items()}
    return {prefix: np.asarray(tree)}


def assert_trees_bit_equal(got, ref):
    got, ref = flat(got), flat(ref)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
        assert np.array_equal(got[k], ref[k]), k


@pytest.fixture(scope="module")
def openai_sd():
    from evr_tpu.models import clip as jclip

    params = jax.tree.map(np.asarray, jinit_clip(jax.random.PRNGKey(3), small_cfg(jclip)))
    return {k: torch.from_numpy(np.array(v)) for k, v in jexport.to_openai_state_dict(params).items()}


def test_config_from_openai_state_dict_matches_jax(openai_sd):
    got = timport.config_from_openai_state_dict(openai_sd)
    ref = jimport.config_from_openai_state_dict(openai_sd)
    assert (got.embed_dim, got.vision.__dict__, got.text.__dict__) == (
        ref.embed_dim, ref.vision.__dict__, ref.text.__dict__)
    # heads = width // 64, copied as it is: one head of 64 here, not the 4 of the source
    assert got.vision.heads == got.text.heads == 1


def test_from_openai_state_dict_matches_jax(openai_sd):
    assert_trees_bit_equal(timport.from_openai_state_dict(openai_sd),
                           jimport.from_openai_state_dict(openai_sd))


@pytest.mark.parametrize("layout", ["reference", "reference+classifier", "bare", "numpy-metrics"])
def test_load_checkpoint_matches_jax(openai_sd, tmp_path, layout):
    """A reference file with and without a head, a bare state dict without
    the ``clip_model.`` prefix, and a file whose metrics are numpy scalars
    (which the tensors-only loader refuses and the trusted one reads)."""
    path = tmp_path / "ckpt.pt"
    params = jimport.from_openai_state_dict(openai_sd)
    head = jinit_classifier(jax.random.PRNGKey(4), JClassifierConfig(embed_dim=32, num_classes=3))
    if layout == "bare":
        torch.save(dict(openai_sd), path)
    else:
        metrics = {"loss": np.float32(1.5)} if layout == "numpy-metrics" else {"loss": 1.5}
        jexport.save_reference_checkpoint(
            path, params, head if layout == "reference+classifier" else None, epoch=7, metrics=metrics)
    got, ref = timport.load_checkpoint(str(path)), jimport.load_checkpoint(str(path))
    assert_trees_bit_equal(got["clip"], ref["clip"])
    assert (got["classifier"] is None) == (ref["classifier"] is None) == (layout != "reference+classifier")
    if ref["classifier"] is not None:
        assert_trees_bit_equal(got["classifier"], ref["classifier"])
    assert got["meta"].keys() == ref["meta"].keys()
    assert got["meta"].get("epoch") == ref["meta"].get("epoch")
    # the loaded params encode as the source params do
    pixels = np.random.default_rng(0).normal(size=(2, 32, 32, 3)).astype(np.float32)
    cfg = small_cfg(tclip)
    out = tclip.encode_image(params_from_numpy(got["clip"]), cfg, torch.from_numpy(pixels))
    want = tclip.encode_image(params_from_numpy(params), cfg, torch.from_numpy(pixels))
    assert torch.equal(out, want)


def _tiny_hf_model():
    transformers = pytest.importorskip("transformers")
    HFCLIPConfig, HFCLIPModel = transformers.CLIPConfig, transformers.CLIPModel

    cfg = HFCLIPConfig(
        projection_dim=32,
        text_config={"hidden_size": 64, "intermediate_size": 256, "num_hidden_layers": 2,
                     "num_attention_heads": 4, "max_position_embeddings": 16, "vocab_size": 1000,
                     "hidden_act": "quick_gelu", "eos_token_id": 999, "bos_token_id": 998,
                     "pad_token_id": 0},
        vision_config={"hidden_size": 64, "intermediate_size": 256, "num_hidden_layers": 2,
                       "num_attention_heads": 4, "image_size": 32, "patch_size": 8,
                       "hidden_act": "quick_gelu"},
    )
    torch.manual_seed(0)
    return HFCLIPModel(cfg).eval()


@pytest.fixture(scope="module")
def hf_pair():
    model = _tiny_hf_model()
    params = timport.from_hf_state_dict(model.state_dict(), small_cfg(tclip))
    return model, params


def test_from_hf_state_dict_matches_jax(hf_pair):
    from evr_tpu.models import clip as jclip

    model, params = hf_pair
    assert_trees_bit_equal(params, jimport.from_hf_state_dict(model.state_dict(), small_cfg(jclip)))


@pytest.mark.parametrize("tower", ["image", "text"])
def test_port_towers_match_hf(hf_pair, tower):
    """A2's open cross-check: the port's towers over HF-converted params
    against the HF model's own features, fp32."""
    model, np_params = hf_pair
    params, cfg = params_from_numpy(np_params), small_cfg(tclip)
    rng = np.random.default_rng(1)
    with torch.no_grad():
        if tower == "image":
            pixels = rng.normal(size=(3, 32, 32, 3)).astype(np.float32)
            ref = model.get_image_features(pixel_values=torch.from_numpy(pixels.transpose(0, 3, 1, 2)))
            got = tclip.encode_image(params, cfg, torch.from_numpy(pixels))
        else:
            # ids < 990, one EOS (999, the largest id) per row, zero padding after
            tokens = np.zeros((4, 16), dtype=np.int64)
            for i in range(4):
                n = int(rng.integers(3, 12))
                tokens[i, 0] = 998
                tokens[i, 1:1 + n] = rng.integers(1, 990, size=n)
                tokens[i, 1 + n] = 999
            ref = model.get_text_features(input_ids=torch.from_numpy(tokens))
            got = tclip.encode_text(params, cfg, torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=HF_TOL)
