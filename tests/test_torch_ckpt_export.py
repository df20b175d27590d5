"""The port's checkpoint export (``models/torch_export.py``) against the JAX
package's, on the CPU.

``to_openai_state_dict`` must give the JAX package's state dict bit for bit
(from numpy leaves and from tensors), export then import must give the params
back exactly, and a reference file written by either package must load in
the other, leaf for leaf.
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
from evr_tpu_torch.models import torch_export as texport
from evr_tpu_torch.models import torch_import as timport
from tests.test_torch_ckpt_import import assert_trees_bit_equal, small_cfg


@pytest.fixture(scope="module")
def trees():
    from evr_tpu.models import clip as jclip

    params = jax.tree.map(np.asarray, jinit_clip(jax.random.PRNGKey(5), small_cfg(jclip)))
    head = jax.tree.map(np.asarray, jinit_classifier(
        jax.random.PRNGKey(6), JClassifierConfig(embed_dim=32, num_classes=3)))
    return params, head


@pytest.mark.parametrize("leaves", ["numpy", "tensor"])
def test_to_openai_state_dict_matches_jax(trees, leaves):
    params, _ = trees
    src = params if leaves == "numpy" else params_from_numpy(params)
    got, ref = texport.to_openai_state_dict(src), jexport.to_openai_state_dict(params)
    assert list(got) == list(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and np.array_equal(got[k], np.asarray(ref[k])), k


def test_round_trip_is_exact(trees):
    params, _ = trees
    back = timport.from_openai_state_dict(texport.to_openai_state_dict(params_from_numpy(params)))
    assert_trees_bit_equal(back, params)
    cfg = small_cfg(tclip)
    pixels = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 32, 32, 3)).astype(np.float32))
    assert torch.equal(tclip.encode_image(params_from_numpy(back), cfg, pixels),
                       tclip.encode_image(params_from_numpy(params), cfg, pixels))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_files_load_in_the_other_package(trees, tmp_path, writer):
    params, head = trees
    path = tmp_path / f"{writer}.pt"
    save = texport.save_reference_checkpoint if writer == "port" else jexport.save_reference_checkpoint
    save(path, params_from_numpy(params) if writer == "port" else params,
         params_from_numpy(head) if writer == "port" else head, epoch=3, metrics={"loss": 0.5})
    for load in (timport.load_checkpoint, jimport.load_checkpoint):
        blob = load(str(path))
        assert_trees_bit_equal(blob["clip"], params)
        assert_trees_bit_equal(blob["classifier"], head)
        assert blob["meta"]["epoch"] == 3 and blob["meta"]["metrics"] == {"loss": 0.5}


def test_files_of_both_packages_hold_the_same_state_dict(trees, tmp_path):
    params, head = trees
    texport.save_reference_checkpoint(tmp_path / "t.pt", params_from_numpy(params), params_from_numpy(head))
    jexport.save_reference_checkpoint(tmp_path / "j.pt", params, head)
    got = torch.load(tmp_path / "t.pt", weights_only=True)
    ref = torch.load(tmp_path / "j.pt", weights_only=True)
    assert list(got["model_state_dict"]) == list(ref["model_state_dict"])
    for k, v in ref["model_state_dict"].items():
        assert torch.equal(got["model_state_dict"][k], v), k
    assert (got["epoch"], got["metrics"]) == (ref["epoch"], ref["metrics"])
