"""The port's HF adapters (``evaluation.hf_adapters``) and the projected
ViT entry (``projection_align.ProjectedAdapter``) against ``evr_tpu``'s on
the CPU. Each model is a random-init ``transformers`` model built from a
config in code (no network), one object handed to both packages' adapters,
so their features must be equal; the harness then scores the projected ViT
the same in both."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("transformers")

from evr_tpu.evaluation import hf_adapters as jhf
from evr_tpu.evaluation.compare import ModelComparison as JModelComparison
from evr_tpu.evaluation.datasets import CaptionsTable
from evr_tpu.evaluation.projection_align import ProjectedAdapter as JProjectedAdapter
from evr_tpu_torch.evaluation import hf_adapters as thf
from evr_tpu_torch.evaluation.compare import ModelComparison
from evr_tpu_torch.evaluation.projection_align import ProjectedAdapter, fit_projection

from tests.test_hf_adapters import FakeProcessor, _tiny_clip, _tiny_flava, _tiny_vit

TEXTS = ["a dog", "street fight at night", "two people on a bus", "a red car"]


@pytest.fixture(scope="module")
def image_files(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("hf_imgs")
    rng = np.random.default_rng(0)
    paths = []
    for i in range(6):
        p = root / f"img_{i}.jpg"
        Image.fromarray(rng.integers(0, 255, (40, 40, 3), dtype=np.uint8)).save(p)
        paths.append(str(p))
    return paths


@pytest.mark.parametrize("kind", ["clip", "flava"])
def test_adapters_over_one_model_give_jaxs_features(image_files, kind):
    make, adapter = {"clip": (_tiny_clip, "HFCLIPAdapter"), "flava": (_tiny_flava, "FlavaAdapter")}[kind]
    model = make()
    got = getattr(thf, adapter)(model, processor=FakeProcessor(), batch_size=4, device="cpu")
    ref = getattr(jhf, adapter)(model, processor=FakeProcessor(), batch_size=4, device="cpu")
    np.testing.assert_array_equal(got.encode_image_files(image_files), ref.encode_image_files(image_files))
    np.testing.assert_array_equal(got.encode_texts(TEXTS), ref.encode_texts(TEXTS))


def test_vit_encoder_adapter_matches_jax(image_files):
    model = _tiny_vit()
    got = thf.ViTEncoderAdapter(model, preprocess=FakeProcessor(), batch_size=4, device="cpu")
    ref = jhf.ViTEncoderAdapter(model, preprocess=FakeProcessor(), batch_size=4, device="cpu")
    np.testing.assert_array_equal(got.encode_image_files(image_files), ref.encode_image_files(image_files))
    with pytest.raises(NotImplementedError, match="ProjectedAdapter"):
        got.encode_texts(["x"])


def test_projected_vit_in_the_harness_matches_jax(image_files, tmp_path):
    clip, vit = _tiny_clip(), _tiny_vit()
    clip_t = thf.HFCLIPAdapter(clip, processor=FakeProcessor(), batch_size=4, device="cpu")
    vit_t = thf.ViTEncoderAdapter(vit, preprocess=FakeProcessor(), batch_size=4, device="cpu")
    W = fit_projection(vit_t.encode_image_files(image_files), clip_t.encode_image_files(image_files))
    ds = CaptionsTable()
    for i, p in enumerate(image_files):
        ds.add_image(f"im{i}", p)
        ds.add_caption(f"caption number {i} scene", f"im{i}")
    got = ModelComparison(output_dir=tmp_path / "t", log=lambda *_: None, device="cpu")
    got.register("ViT+proj", lambda: ProjectedAdapter(vit_t, clip_t, W))
    ref = JModelComparison(output_dir=tmp_path / "j", log=lambda *_: None)
    ref.register("ViT+proj", lambda: JProjectedAdapter(
        jhf.ViTEncoderAdapter(vit, preprocess=FakeProcessor(), batch_size=4),
        jhf.HFCLIPAdapter(clip, processor=FakeProcessor(), batch_size=4), W))
    g, r = got.run_evaluation(ds)["ViT+proj"], ref.run_evaluation(ds)["ViT+proj"]
    for direction in ("t2i", "i2t", "mean"):
        for k, v in r[direction].items():
            np.testing.assert_allclose(g[direction][k], v, rtol=0, atol=1e-5, err_msg=f"{direction} {k}")
    assert g["t2i_ranks"] == r["t2i_ranks"] and g["i2t_ranks"] == r["i2t_ranks"]


def test_adapters_run_on_the_card_unless_the_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        thf.HFCLIPAdapter(_tiny_clip(), processor=FakeProcessor())
