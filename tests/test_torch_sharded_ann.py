"""The sharded ANN tiers in the port (``evr_tpu_torch.parallel.sharded_ann``,
``FrameIndex(mesh=, search_impl="ivf"|"ivfpq")``, ``serving --shard-index
--search-impl ivfpq``) held to ``tests/test_sharded_ann.py``.

k-means draws cannot match across the packages, so the shards JAX's
sharded index builds (``IVFIndex().build`` / ``IVFPQIndex().build_device``
at seed + i over its balanced row range, caught as it builds them) are
saved and loaded into the port (as ``tests/test_torch_ivf.py::
test_port_searches_a_jax_built_index`` does); the port's sharded search
over those shards must give JAX's ``ShardedIVF*Index.search``: rows equal,
scores within 1e-5. Port-built indexes are held to brute force at a full
probe, and ``FrameIndex(mesh=)`` to JAX's ``FrameIndex(mesh=)`` at a full
probe (ivfpq: the re-rank covers every shard's rows), on conftest's 8 host
devices and 8 CPU slots."""

import json
from unittest import mock

import numpy as np
import pytest

from evr_tpu.index import FrameIndex as JFrameIndex
from evr_tpu.index import IVFIndex as JIVF, IVFPQIndex as JIVFPQ
from evr_tpu.parallel import get_mesh as jget_mesh
from evr_tpu.parallel.sharded_ann import ShardedIVFIndex as JShardedIVF
from evr_tpu.parallel.sharded_ann import ShardedIVFPQIndex as JShardedIVFPQ
from evr_tpu.parallel.sharded_ann import _balanced_ranges as jranges
from evr_tpu_torch.index import FrameIndex, IVFIndex, IVFPQIndex
from evr_tpu_torch.parallel import get_mesh
from evr_tpu_torch.parallel.sharded_ann import ShardedIVFIndex, ShardedIVFPQIndex, _balanced_ranges

from torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
PQ = dict(n_subspaces=8, n_centroids=64, capacity_factor=1.5, coarse_iters=6, pq_iters=6)


def _corpus(n=1603, d=32, seed=0):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(n, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    q = emb[rng.integers(0, n, 6)] + 0.02 * rng.normal(size=(6, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return emb, q.astype(np.float32)


def _exact(q, emb, k):
    scores = q @ emb.T
    rows = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(scores, rows, 1), rows


@pytest.fixture(scope="module")
def meshes():
    return jget_mesh(8), get_mesh(8, device="cpu")


def test_balanced_ranges_match_jax():
    for n in (8, 9, 15, 16, 17, 100, 1001):
        assert _balanced_ranges(n, 8) == jranges(n, 8)
    with pytest.raises(ValueError, match="cannot shard"):
        _balanced_ranges(7, 8)


def test_ivf_full_probe_matches_brute_force(meshes):
    """Port-built shards: a full probe is the exact global top-k (fp32);
    bf16 keeps the top-1; more clusters than the smallest shard refuse."""
    _, mesh = meshes
    emb, q = _corpus()
    idx = ShardedIVFIndex(mesh).build(emb, n_clusters=8, seed=0)
    assert len(idx.shards) == 8 and idx.offsets == [b for b, _ in _balanced_ranges(len(emb), 8)]
    s, r = idx.search(q, 10, nprobe=8)
    es, er = _exact(q, emb, 10)
    np.testing.assert_array_equal(r, er)
    np.testing.assert_allclose(s, es, atol=1e-5)
    bf = ShardedIVFIndex(mesh).build(emb, n_clusters=8, seed=2, dtype="bfloat16")
    np.testing.assert_array_equal(bf.search(q, 5, nprobe=8)[1][:, 0], er[:, 0])
    with pytest.raises(ValueError, match="smallest shard"):
        ShardedIVFIndex(mesh).build(emb[:64], n_clusters=32)


def test_ivf_every_row_reachable_and_recall_monotone(meshes):
    _, mesh = meshes
    emb, q = _corpus(n=1000)
    idx = ShardedIVFIndex(mesh).build(emb, n_clusters=10, seed=1)
    _, rows = idx.search(emb[::97], 1, nprobe=10)
    np.testing.assert_array_equal(rows[:, 0], np.arange(0, 1000, 97))
    exact = _exact(q, emb, 10)[1]
    recalls = [np.mean([len(set(a) & set(b)) / 10 for a, b in zip(idx.search(q, 10, nprobe=p)[1], exact)])
               for p in (1, 4, 10)]
    assert recalls == sorted(recalls) and recalls[-1] == 1.0


def _built_by(cls, method: str, build, tmp_path, load):
    """``build()`` (a JAX sharded index's build) with ``cls.method`` wrapped
    to keep every sub-index it builds: (its result, the sub-indexes saved
    and loaded into the port with ``load``)."""
    subs = []
    inner = getattr(cls, method)

    def keep(self, *args, **kwargs):
        subs.append(inner(self, *args, **kwargs))
        return subs[-1]

    with mock.patch.object(cls, method, keep):
        out = build()
    for i, sub in enumerate(subs):
        sub.save(tmp_path / f"s{i}.npz")
    return out, [load(tmp_path / f"s{i}.npz", device="cpu") for i in range(len(subs))]


def test_ivf_search_matches_jax_over_jax_built_shards(meshes, tmp_path):
    """JAX's shards loaded into the port: the port's sharded search equals
    ``ShardedIVFIndex.search`` at nprobe 1, 4 and 8 (rows equal, scores
    1e-5); a shard's offset moved by one row fails."""
    jmesh, mesh = meshes
    emb, q = _corpus()
    jidx, subs = _built_by(JIVF, "build", lambda: JShardedIVF(jmesh).build(emb, n_clusters=8, seed=0),
                           tmp_path, IVFIndex.load)
    idx = ShardedIVFIndex.from_shards(mesh, subs, len(emb))
    for nprobe in (1, 4, 8):
        js, jr = jidx.search(q, 10, nprobe=nprobe)
        ts, tr = idx.search(q, 10, nprobe=nprobe)
        np.testing.assert_array_equal(tr, jr)
        np.testing.assert_allclose(ts, js, **TOL)
    idx.offsets[3] += 1
    assert not np.array_equal(idx.search(emb[600:606], 3, nprobe=8)[1], jidx.search(emb[600:606], 3, nprobe=8)[1])


def test_ivfpq_search_matches_jax_over_jax_built_shards(tmp_path):
    """JAX's IVF-PQ shards (``build_device`` at seed + i, packed) loaded into
    the port over 4 slots: the ADC search (``adc_impl`` "xla" and "pallas",
    K7's plain version here) and the re-ranked search equal JAX's
    ``ShardedIVFPQIndex.search`` (rows equal, scores 1e-5)."""
    jmesh, mesh = jget_mesh(4), get_mesh(4, device="cpu")
    emb, q = _corpus(n=1203)
    jidx, subs = _built_by(JIVFPQ, "build_device", lambda: JShardedIVFPQ(jmesh).build(emb, n_clusters=8, seed=0, **PQ),
                           tmp_path, IVFPQIndex.load)
    assert len(subs) == 4
    idx = ShardedIVFPQIndex.from_shards(mesh, subs, len(emb), originals=emb)
    for nprobe, rerank in ((1, None), (4, 60), (8, 400)):
        js, jr = jidx.search(q, 10, nprobe=nprobe, rerank=rerank, adc_impl="xla")
        for impl in ("xla", "pallas"):
            ts, tr = idx.search(q, 10, nprobe=nprobe, rerank=rerank, adc_impl=impl)
            np.testing.assert_array_equal(tr, jr, err_msg=f"{nprobe} {rerank} {impl}")
            np.testing.assert_allclose(ts, js, **TOL)
    with pytest.raises(ValueError, match="adc_impl"):
        idx.search(q, 10, nprobe=8, adc_impl="faiss")


def test_ivfpq_full_probe_rerank_matches_brute_force(meshes):
    """Port-built shards: a full probe and a re-rank deeper than one shard's
    rows (1,000 over 125-row shards) give the exact global top-k; the ADC
    search wider than one shard still fills; more clusters than the
    smallest shard refuse."""
    _, mesh = meshes
    emb, q = _corpus(n=1000)
    idx = ShardedIVFPQIndex(mesh).build(emb, n_clusters=8, seed=3, **PQ)
    es, er = _exact(q, emb, 10)
    s, r = idx.search(q, 10, nprobe=8, rerank=1000)
    np.testing.assert_array_equal(r, er)
    np.testing.assert_allclose(s, es, atol=1e-5)
    s2, r2 = idx.search(q, 200, nprobe=8)
    assert r2.shape == (6, 200) and np.isfinite(s2).all()
    assert all(len(set(x.tolist())) == 200 for x in r2) and r2.max() < 1000
    with pytest.raises(ValueError, match="smallest shard"):
        ShardedIVFPQIndex(mesh).build(emb[:64], n_clusters=32, n_subspaces=8)


def test_ivfpq_host_store_rerank_source(meshes):
    _, mesh = meshes
    emb, q = _corpus(n=800)
    idx = ShardedIVFPQIndex(mesh).build(emb, n_clusters=8, seed=2, keep_originals=False, **PQ)
    with pytest.raises(ValueError, match="rerank requires"):
        idx.search(q, 5, nprobe=8, rerank=100)
    scales = np.maximum(np.abs(emb).max(axis=1) / 127.0, 1e-12).astype(np.float32)
    rows8 = np.clip(np.round(emb / scales[:, None]), -127, 127).astype(np.int8)
    with pytest.raises(ValueError, match="host store rows"):
        idx.attach_host_store(rows8[:10], scales[:10])
    idx.attach_host_store(rows8, scales)
    _, rows = idx.search(q, 5, nprobe=8, rerank=400)
    np.testing.assert_array_equal(rows[:, 0], _exact(q, emb, 5)[1][:, 0])


@pytest.mark.parametrize("impl", ["ivf", "ivfpq"])
def test_frame_index_mesh_tier_matches_jax(impl):
    """``FrameIndex(mesh=, search_impl=impl)`` at a full probe against JAX's
    ``FrameIndex(mesh=)``: the sharded tier is built (256 rows over 4
    shards), global searches give JAX's rows and scores within 1e-5,
    video-scoped ones stay exact, and a corpus under two rows a shard takes
    the one-device tier."""
    jmesh, mesh = jget_mesh(4), get_mesh(4, device="cpu")
    emb, q = _corpus(n=256, d=32, seed=3 if impl == "ivf" else 5)
    kw = dict(embed_dim=32, search_impl=impl, ivf_nprobe=4, ivf_clusters=4)
    fi, jfi = FrameIndex(mesh=mesh, **kw), JFrameIndex(mesh=jmesh, **kw)
    for ix in (fi, jfi):
        ix.add_video("a", emb[:150])
        ix.add_video("b", emb[150:])
    s, r = fi.search_raw(q, 10)
    js, jr = jfi.search_raw(q, 10)
    assert isinstance(fi._ivf, ShardedIVFIndex if impl == "ivf" else ShardedIVFPQIndex)
    np.testing.assert_array_equal(r, jr)
    np.testing.assert_allclose(s, js, **TOL)
    np.testing.assert_array_equal(r, _exact(q, emb, 10)[1])
    hits = fi.search(q[:1], top_k=3, video_name="b")[0]
    assert [h.row for h in hits] == [h.row for h in jfi.search(q[:1], top_k=3, video_name="b")[0]]
    tiny = FrameIndex(embed_dim=32, mesh=mesh, search_impl=impl, ivf_clusters=2, ivf_nprobe=2)
    tiny.add_video("t", emb[:6])
    s2, r2 = tiny.search_raw(q[:2], 3)
    assert r2.shape == (2, 3) and np.isfinite(s2).all()
    assert not isinstance(tiny._ivf, (ShardedIVFIndex, ShardedIVFPQIndex))


def test_shard_index_cli_serves_ivfpq(tmp_path, monkeypatch, capsys):
    """``python -m evr_tpu_torch.serving --shard-index --search-impl ivfpq``
    over ``EVR_TPU_CPU_DEVICES=4`` CPU slots boots on the sharded IVF-PQ
    tier and its ``/api/search`` events equal the one-device exact
    server's at a full probe."""
    import werkzeug.serving
    from werkzeug.test import Client

    from evr_tpu_torch.config import DataRootConfig
    from evr_tpu_torch.index import VideoRegistry
    from evr_tpu_torch.serving.__main__ import main

    root = DataRootConfig(tmp_path / "data").ensure()
    reg = VideoRegistry(root.mapping_path)
    rng = np.random.default_rng(8)
    for name, n in (("clipA", 90), ("clipB", 70)):
        emb = rng.standard_normal((n, 32)).astype(np.float32)
        np.save(root.embedding_dir / f"{name}_embeddings.npy", emb / np.linalg.norm(emb, axis=1, keepdims=True))
        records = [{"id": f"{name}-{i}", "frameid": f"{i}.jpg", "frameidx": i, "video": f"videos/{name}.mp4"}
                   for i in range(n)]
        (root.metadata_dir / f"{name}_metadata.json").write_text(json.dumps(records))
        (root.video_dir / f"{name}.mp4").write_bytes(b"0000")
        reg.add(name, metadata_file=f"metadata/{name}_metadata.json", embeddings_file=f"embedding/{name}_embeddings.npy",
                video_path=f"videos/{name}.mp4", embedding_model="original")
    apps = {}
    monkeypatch.setattr(werkzeug.serving, "run_simple", lambda host, port, app, **kw: apps.setdefault(port, app))
    monkeypatch.setenv("EVR_TPU_CPU_DEVICES", "4")
    base = ["--data-root", str(root.root), "--device", "cpu", "--model", "ViT-Tiny-Test", "--batch-size", "8"]
    main(base + ["--port", "1", "--shard-index", "--search-impl", "ivfpq", "--ivf-clusters", "4",
                 "--ivf-nprobe", "4"])
    assert "sharding over {'data': 4} mesh" in capsys.readouterr().out
    main(base + ["--port", "2"])
    sharded, plain = Client(apps[1]), Client(apps[2])
    for q, k in (("red scene", 5), ("a car", 7)):
        body = {"search_type": "text", "search_method": "text_clip", "query": q, "top_k": k}
        got = json.loads(sharded.post("/api/search", json=body).data)["events"]
        ref = json.loads(plain.post("/api/search", json=body).data)["events"]
        assert len(got) == k and [(e["videoId"], e["id"]) for e in got] == [(e["videoId"], e["id"]) for e in ref]
