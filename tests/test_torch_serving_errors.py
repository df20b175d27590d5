"""The PyTorch port's HTTP API rejects what the JAX app rejects, and names
what it has not ported yet.

Both apps run over empty data roots (request validation happens before any
search); a malformed ``/api/search`` body must give the JAX app's status and
payload, as must the requests that answered 501 before their routes and
methods were ported (upload without a file, the status of an unknown upload
job among them).
"""

import json

import numpy as np
import pytest

pytest.importorskip("werkzeug")

import jax
from werkzeug.test import Client

from evr_tpu.config import DataRootConfig as JRoot
from evr_tpu.index import EmbeddingEngine as JEngine
from evr_tpu.models.clip import init_clip_params
from evr_tpu.models.variants import get_model_config
from evr_tpu.serving import ServingContext as JContext, create_app as jcreate_app
from evr_tpu_torch.config import DataRootConfig as TRoot
from evr_tpu_torch.index import EmbeddingEngine as TEngine
from evr_tpu_torch.serving import ServingContext as TContext, create_app as tcreate_app


@pytest.fixture(scope="module")
def clients(tmp_path_factory):
    cfg = get_model_config("ViT-Tiny-Test")
    params = jax.tree.map(np.asarray, init_clip_params(jax.random.PRNGKey(0), cfg))
    base = tmp_path_factory.mktemp("serving_errors")
    jroot, troot = JRoot(base / "jax").ensure(), TRoot(base / "torch").ensure()
    jctx = JContext(jroot, engine=JEngine("ViT-Tiny-Test", params=params, cfg=cfg, batch_size=4))
    tctx = TContext(troot, engine=TEngine("ViT-Tiny-Test", params=params, batch_size=4, device="cpu"))
    assert jctx.boot() == tctx.boot() == []
    return Client(jcreate_app(jctx)), Client(tcreate_app(tctx))


def _payload(resp):
    return json.loads(resp.get_data(as_text=True))


@pytest.mark.parametrize("body", [
    {"top_k": "many"},
    {"query": ["not", "a", "string"]},
    {"mmr_lambda": 2.0, "query": "x"},
    {"search_method": "keyword_only", "negative_query": "y", "query": "x"},
    {"negative_weight": -1, "query": "x"},
])
def test_validation_errors_match(clients, body):
    jc, tc = clients
    jr, tr = jc.post("/api/search", json=body), tc.post("/api/search", json=body)
    assert tr.status_code == jr.status_code == 400
    assert _payload(tr) == _payload(jr)


@pytest.mark.parametrize("method,path,body", [
    ("POST", "/api/search", {"search_type": "image", "image_url": "x.jpg"}),
    ("POST", "/api/search", {"search_method": "keyword_only", "query": "exit"}),
    ("GET", "/api/models", None),
    ("GET", "/api/video/video-1/events", None),
    ("GET", "/api/search", None),
    ("POST", "/api/upload-video", {}),
    ("POST", "/api/upload-video", {"sync": "1"}),
    ("GET", "/api/upload-status/job-1", None),
])
def test_formerly_unported_requests_match_jax(clients, method, path, body):
    jc, tc = clients
    jr, tr = jc.open(path, method=method, json=body), tc.open(path, method=method, json=body)
    assert tr.status_code == jr.status_code
    assert _payload(tr) == _payload(jr)
