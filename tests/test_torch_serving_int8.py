"""int8 serving of the PyTorch port against the JAX package's, end to end.

Both engines serve int8 weights quantized from the same (carried-over)
ViT-Tiny-Test params; each data root holds the frame embeddings its own
engine computed from the same frames; both contexts store the index in int8
and search it with the fused top-k (``search_impl="pallas"``: the JAX Pallas
kernel in interpret mode, the port's K4 through its plain version on the
CPU). The port's ``/api/search`` payloads must equal the JAX app's, with
scores within 5e-3 (ROADMAP's int8 tolerance: an activation or an index value
that lands on the other side of a quantisation step moves a score by about
one step). The tiny random towers give near ties, so two events may trade
places, and one may cross the cut, only where their scores lie within that
tolerance of each other.
"""

import subprocess
import sys

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
pytest.importorskip("werkzeug")

import jax
import torch
from werkzeug.test import Client

from evr_tpu.config import DataRootConfig as JRoot
from evr_tpu.index import EmbeddingEngine as JEngine
from evr_tpu.models.clip import init_clip_params
from evr_tpu.models.variants import get_model_config
from evr_tpu.query.text import identity_preprocessor
from evr_tpu.serving import ServingContext as JContext, create_app as jcreate_app
from evr_tpu_torch.config import DataRootConfig as TRoot
from evr_tpu_torch.index import EmbeddingEngine as TEngine
from evr_tpu_torch.serving import ServingContext as TContext, create_app as tcreate_app

from test_torch_serving import _payload, _write_root

INT8_TOL = 5e-3
MODEL = "ViT-Tiny-Test"
VIDEOS = {"clipA": 9, "clipB": 6, "clipC": 7}
QUERIES = ["a red car", "people walking", "an exit sign", "a dog"]


def _frames(n, seed, size):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def engines():
    cfg = get_model_config(MODEL)
    params = jax.tree.map(np.asarray, init_clip_params(jax.random.PRNGKey(0), cfg))
    jeng = JEngine(MODEL, params=params, cfg=cfg, batch_size=4, params_dtype="int8")
    teng = TEngine(MODEL, params=params, batch_size=4, device="cpu", params_dtype="int8")
    return cfg, params, jeng, teng


@pytest.fixture(scope="module")
def contexts(engines, tmp_path_factory):
    cfg, _, jeng, teng = engines
    size = cfg.vision.image_size
    frames = {name: _frames(n, i, size) for i, (name, n) in enumerate(VIDEOS.items())}
    base = tmp_path_factory.mktemp("serving_int8")
    jroot, troot = JRoot(base / "jax"), TRoot(base / "torch")
    _write_root(jroot, jeng, frames)
    _write_root(troot, teng, frames)
    jctx = JContext(jroot, engine=jeng, preprocessor=identity_preprocessor,
                    index_dtype="int8", search_impl="pallas")
    tctx = TContext(troot, engine=teng, index_dtype="int8", search_impl="pallas")
    assert jctx.boot() == tctx.boot() == list(VIDEOS)
    return jctx, tctx


def _unit(e):
    return e / np.linalg.norm(e, axis=-1, keepdims=True)


def test_int8_engine_matches_jax(engines):
    """Same frames and queries through both int8 towers; the weights keep
    the JAX package's formats: int8 kernels, fp32 scales, the rest as given."""
    cfg, _, jeng, teng = engines
    blk = teng.params["visual"]["blocks"][0]
    assert blk["attn"]["qkv"]["kernel_q"].dtype == torch.int8
    assert blk["attn"]["qkv"]["kernel_scale"].dtype == torch.float32
    assert blk["mlp"]["fc"]["bias"].dtype == torch.float32
    assert teng.params["visual"]["proj"].dtype == torch.float32
    frames = _frames(6, 9, cfg.vision.image_size)
    ref = _unit(jeng.encode_staged_images(frames))
    got = _unit(teng.encode_staged_images(frames))
    np.testing.assert_allclose(got, ref, rtol=0, atol=INT8_TOL)
    assert (got * ref).sum(1).min() >= 0.9999
    np.testing.assert_allclose(teng.encode_texts(QUERIES), jeng.encode_texts(QUERIES),
                               rtol=0, atol=INT8_TOL)


def test_registered_models_inherit_int8(engines):
    cfg, params, _, _ = engines
    teng = TEngine(MODEL, params=params, batch_size=4, device="cpu", params_dtype="int8")
    teng.register_model("second", params)
    assert teng.models["second"]["clip"]["text"]["blocks"][1]["mlp"]["proj"]["kernel_q"].dtype == torch.int8


def test_context_indexes_are_int8_and_fused(contexts):
    _, tctx = contexts
    ix = tctx.index
    assert (ix.device_dtype, ix.search_impl) == ("int8", "pallas")
    ix.build()
    assert ix._device_index.dtype == torch.int8 and ix._row_scales is not None


SEARCHES = [
    {"search_method": "text_clip", "query": "a red car", "top_k": 5},
    {"search_method": "text_clip", "query": "a red car", "top_k": 4, "videoId": "video-2"},
    {"search_method": "text_adaptive", "query": "people walking", "top_k": 6,
     "adaptive_threshold": -1.0},
    {"search_method": "text_clip", "query": "a dog", "top_k": 5, "negative_query": "a cat"},
]


@pytest.mark.parametrize("body", SEARCHES, ids=lambda b: f"{b['search_method']}-{b.get('videoId', 'all')}-{b['top_k']}")
def test_int8_search_payloads_match_jax(contexts, body):
    jctx, tctx = contexts
    jr = Client(jcreate_app(jctx)).post("/api/search", json={"search_type": "text", **body})
    tr = Client(tcreate_app(tctx)).post("/api/search", json={"search_type": "text", **body})
    assert tr.status_code == jr.status_code == 200
    got, ref = _payload(tr)["events"], _payload(jr)["events"]
    assert len(got) == len(ref) > 0
    key = lambda e: (e["videoId"], e["id"])  # noqa: E731
    by_key = {key(r): r for r in ref}
    for pos, g in enumerate(got):
        r = by_key.get(key(g))
        if r is None:  # crossed the cut: a near tie of the JAX list's last event
            assert g["clip_similarity"] - ref[-1]["clip_similarity"] <= INT8_TOL, key(g)
            continue
        assert set(g) == set(r)
        for name in r:
            if name in ("clip_similarity", "confidence"):
                assert abs(g[name] - r[name]) <= INT8_TOL, (name, g[name], r[name])
            else:
                assert g[name] == r[name], name
        # out of place only against a near tie
        other = ref[pos]
        assert abs(other["clip_similarity"] - r["clip_similarity"]) <= INT8_TOL, key(g)


def test_cli_serves_int8_and_the_fused_search():
    out = subprocess.run(
        [sys.executable, "-m", "evr_tpu_torch.serving", "--help"],
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    text = " ".join(out.stdout.split())
    assert "--params-dtype {float32,bfloat16,int8,auto}" in text
    assert "--search-impl {xla,pallas,ivf,ivfpq}" in text
