"""The ANN tiers of the PyTorch port end to end: serving and the offline CLI.

Both packages' ``ServingContext``s boot the same data root (synthetic unit
embeddings of the ``ViT-Tiny-Test`` width, the engines carrying the same
params). Under ``search_impl="ivf"`` with ``ivf_nprobe = ivf_clusters`` a
global search reads every row in both packages, so the k-means draws do not
matter: the port's ``/api/search`` payloads must equal the JAX app's (the
same events in the same order, scores within 2e-4, the bound of the text
encode). Under ``"ivfpq"``, with and without the int8 host store, the
payloads have the JAX app's keys and shape, and the top-1 of perturbed
corpus frames is the exact one (as ``tests/test_ivfpq_serving.py`` asserts
for JAX). ``tools.index_tool`` round trips (build, then query) are checked
against the JAX package searching the saved index.
"""

import contextlib
import io
import json

import numpy as np
import pytest

pytest.importorskip("werkzeug")

import jax
from werkzeug.test import Client

from evr_tpu.config import DataRootConfig as JRoot
from evr_tpu.index import EmbeddingEngine as JEngine
from evr_tpu.index import IVFIndex as JIVF, IVFPQIndex as JIVFPQ, PQIndex as JPQ
from evr_tpu.models.clip import init_clip_params
from evr_tpu.models.variants import get_model_config
from evr_tpu.query.text import identity_preprocessor
from evr_tpu.serving import ServingContext as JContext, create_app as jcreate_app
from evr_tpu_torch.config import DataRootConfig as TRoot
from evr_tpu_torch.index import EmbeddingEngine as TEngine, FrameIndex, VideoRegistry
from evr_tpu_torch.serving import ServingContext as TContext, create_app as tcreate_app
from evr_tpu_torch.tools import index_tool

from test_torch_serving import _payload, _same_events

VIDEOS = {"clipA": 160, "clipB": 120, "clipC": 140}
LISTS = 8


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(JAX engine, port engine, data root, corpus rows in row order)."""
    cfg = get_model_config("ViT-Tiny-Test")
    params = jax.tree.map(np.asarray, init_clip_params(jax.random.PRNGKey(0), cfg))
    jeng = JEngine("ViT-Tiny-Test", params=params, cfg=cfg, batch_size=4)
    teng = TEngine("ViT-Tiny-Test", params=params, batch_size=4, device="cpu")
    root = TRoot(tmp_path_factory.mktemp("ann_root")).ensure()
    reg = VideoRegistry(root.mapping_path)
    rng = np.random.default_rng(8)
    rows = []
    for name, n in VIDEOS.items():
        emb = _unit(rng.standard_normal((n, cfg.embed_dim)))
        rows.append(emb)
        np.save(root.embedding_dir / f"{name}_embeddings.npy", emb)
        records = [{"id": f"{name}-{i}", "frameid": f"{i}.jpg", "frameidx": i,
                    "video": f"videos/{name}.mp4"} for i in range(n)]
        (root.metadata_dir / f"{name}_metadata.json").write_text(json.dumps(records))
        (root.video_dir / f"{name}.mp4").write_bytes(b"0000")
        reg.add(name, metadata_file=f"metadata/{name}_metadata.json",
                embeddings_file=f"embedding/{name}_embeddings.npy",
                video_path=f"videos/{name}.mp4", embedding_model="original")
    return jeng, teng, root.root, np.concatenate(rows)


def _contexts(setup, **kw):
    jeng, teng, root, _ = setup
    jctx = JContext(JRoot(root), engine=jeng, preprocessor=identity_preprocessor, **kw)
    tctx = TContext(TRoot(root), engine=teng, **kw)
    assert jctx.boot() == tctx.boot() == list(VIDEOS)
    return jctx, tctx


@pytest.fixture(scope="module")
def ivf_clients(setup):
    jctx, tctx = _contexts(setup, search_impl="ivf", ivf_clusters=LISTS, ivf_nprobe=LISTS)
    return Client(jcreate_app(jctx)), Client(tcreate_app(tctx)), tctx


SEARCHES = [
    {"search_method": "text_clip", "query": "a red car", "top_k": 5},
    {"search_method": "text_adaptive", "query": "people walking", "top_k": 8,
     "adaptive_threshold": -1.0},
    {"search_method": "text_clip", "query": "a dog", "top_k": 4, "videoId": "video-2"},
]


@pytest.mark.parametrize("body", SEARCHES, ids=["clip", "adaptive", "scoped"])
def test_ivf_full_probe_payloads_match_jax(ivf_clients, body):
    jc, tc, tctx = ivf_clients
    jr = jc.post("/api/search", json={"search_type": "text", **body})
    tr = tc.post("/api/search", json={"search_type": "text", **body})
    assert tr.status_code == jr.status_code == 200
    _same_events(_payload(tr)["events"], _payload(jr)["events"])
    ann = tctx.index._ivf
    assert ann is not None and ann.n_clusters == LISTS and tctx.index.search_impl == "ivf"


@pytest.mark.parametrize("host_store", [False, True], ids=["originals", "host-store"])
def test_ivfpq_serving_shape_and_top1(setup, host_store):
    _, _, _, rows = setup
    jctx, tctx = _contexts(setup, search_impl="ivfpq", ivf_clusters=LISTS, ivf_nprobe=4,
                           ivfpq_host_store=host_store)
    body = {"search_type": "text", "search_method": "text_clip", "query": "a boat", "top_k": 6}
    jr = _payload(Client(jcreate_app(jctx)).post("/api/search", json=body))
    tr = _payload(Client(tcreate_app(tctx)).post("/api/search", json=body))
    assert set(tr) == set(jr) and len(tr["events"]) == len(jr["events"]) > 0
    assert [set(e) for e in tr["events"]] == [set(e) for e in jr["events"]]
    ann = tctx.index._ivf
    assert (ann._originals is None) == host_store and (ann._originals_int8 is not None) == host_store
    picks = np.arange(0, len(rows), 37)
    q = _unit(rows[picks] + 0.02 * np.random.default_rng(1).standard_normal((len(picks), rows.shape[1])))
    exact = np.argsort(-(q @ rows.T), axis=1)[:, 0]
    for ctx in (tctx, jctx):
        s, r = ctx.index.search_raw(q, 5)
        np.testing.assert_array_equal(r[:, 0], exact)
        assert r.shape == (len(picks), 5) and np.isfinite(s).all()


def test_ann_append_lockstep_and_rebuild_bound(setup):
    _, _, _, rows = setup
    for impl, kw in (("ivf", {}), ("ivfpq", {"ivfpq_host_store": True})):
        fi = FrameIndex(embed_dim=rows.shape[1], search_impl=impl, ivf_clusters=4, ivf_nprobe=4,
                        device="cpu", **kw)
        fi.add_video("a", rows[:200])
        fi.search_raw(rows[:2], 3)  # builds the ANN index
        built = fi._ivf
        fi.add_video("b", rows[200:280])  # within 1.5x of the build: appended
        assert fi._ivf is built and built.n_rows == 280
        if impl == "ivfpq":
            assert built._originals_int8.shape[0] == 280  # the host store follows the ids
        _, r = fi.search_raw(rows[[250, 270]], 1)
        np.testing.assert_array_equal(r[:, 0], [250, 270])
        fi.add_video("c", rows[280:400])  # past 1.5x: the next search rebuilds
        fi.search_raw(rows[:1], 1)
        assert fi._ivf is not built and fi._ivf.n_rows == 400
        _, r = fi.search_raw(rows[[390]], 2, video_name="c")  # scoped: exact
        assert r[0, 0] == 390


def _run_tool(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        index_tool.main(argv + ["--device", "cpu"])
    return [json.loads(line) for line in buf.getvalue().splitlines()]


@pytest.mark.parametrize("kind", ["ivf", "pq", "ivfpq-streamed"])
def test_index_tool_round_trip(kind, setup, tmp_path):
    _, _, _, rows = setup
    typ = kind.split("-")[0]
    np.save(tmp_path / "emb.npy", rows * 3.0)  # the tool normalises rows
    q = _unit(rows[[3, 150, 400]] + 0.05)
    np.save(tmp_path / "q.npy", q)
    build = ["build", "--embeddings", str(tmp_path / "emb.npy"), "--type", typ, "--out",
             str(tmp_path / "idx.npz"), "--iters", "4", "--subspaces", "8", "--centroids", "32"]
    query = ["query", "--index", str(tmp_path / "idx.npz"), "--type", typ,
             "--query-embeddings", str(tmp_path / "q.npy"), "--top-k", "5", "--nprobe", "6"]
    if kind == "ivfpq-streamed":
        build += ["--streamed", "--host-store", str(tmp_path / "store")]
        query += ["--rerank", "20", "--host-store", str(tmp_path / "store")]
    elif kind == "pq":
        query += ["--rerank", "20"]
    (built,) = _run_tool(build)
    assert built["rows"] == len(rows) and built["dim"] == rows.shape[1]
    assert built.get("streamed", False) == (kind == "ivfpq-streamed")
    lines = _run_tool(query)
    assert len(lines) == len(q) + 1 and lines[-1]["queries"] == len(q)
    jidx = {"ivf": JIVF, "pq": JPQ, "ivfpq": JIVFPQ}[typ].load(tmp_path / "idx.npz")
    kw = {"nprobe": 6} if typ != "pq" else {}
    if kind != "ivf":
        kw["rerank"] = 20
    if kind == "ivfpq-streamed":
        jidx.attach_host_store(np.load(tmp_path / "store.rows.npy"),
                               np.load(tmp_path / "store.scales.npy"))
    _, jrows = jidx.search(q, 5, **kw)
    for line, want in zip(lines, jrows):
        assert [h["row"] for h in line["hits"]] == [int(r) for r in want if r >= 0]


def test_index_tool_text_query_and_refusals(setup, tmp_path):
    _, teng, _, rows = setup
    np.save(tmp_path / "emb.npy", rows)
    _run_tool(["build", "--embeddings", str(tmp_path / "emb.npy"), "--type", "ivf", "--out",
               str(tmp_path / "i.npz"), "--clusters", "4", "--iters", "3"])
    lines = _run_tool(["query", "--index", str(tmp_path / "i.npz"), "--type", "ivf", "--query",
                       "a red car", "--model", "ViT-Tiny-Test", "--top-k", "3", "--nprobe", "4"])
    # the tool's engine draws its weights from seed 0, as a fresh engine does
    text = TEngine("ViT-Tiny-Test", device="cpu").encode_texts(["a red car"])[0]
    want = np.argsort(-(rows @ text))[:3]
    assert [h["row"] for h in lines[0]["hits"]] == want.tolist()
    with pytest.raises(SystemExit, match="query-embeddings"):
        _run_tool(["query", "--index", str(tmp_path / "i.npz"), "--type", "ivf"])
    # invalid tier combinations fail at boot; an ANN tier under a mesh boots sharded
    with pytest.raises(ValueError, match="ivfpq_host_store requires"):
        TContext(TRoot(tmp_path), engine=teng, ivfpq_host_store=True)
    with pytest.raises(ValueError, match="float32/bfloat16"):
        TContext(TRoot(tmp_path), engine=teng, search_impl="ivfpq", index_dtype="int8")
    from evr_tpu_torch.parallel import get_mesh
    from evr_tpu_torch.parallel.sharded_ann import ShardedIVFIndex

    sharded = TContext(TRoot(setup[2]), engine=teng, search_impl="ivf", ivf_clusters=LISTS, ivf_nprobe=LISTS,
                       mesh=get_mesh(4, device="cpu"))
    sharded.boot()
    _, got = sharded.index.search_raw(rows[:3], 5)
    assert isinstance(sharded.index._ivf, ShardedIVFIndex)
    assert got.tolist() == np.argsort(-(rows[:3] @ rows.T), axis=1, kind="stable")[:, :5].tolist()
