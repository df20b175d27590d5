"""The port's meshes (``evr_tpu_torch.parallel.mesh``), the mesh engine and
sharded serving, held to ``tests/test_parallel.py::test_mesh_shapes``,
``tests/test_multislice.py::test_multislice_mesh_shapes`` and the first two
tests of ``tests/test_mesh_engine.py``: a mesh of CPU slots (the CPU listed
in each) splits every encode batch over its slots and the rows equal the
one-device engine's (bf16 and int8 weights); a serving context over a mesh
ingests and searches as the unsharded one does; ``python -m
evr_tpu_torch.serving --shard-index`` boots and answers ``/api/search`` with
the unsharded server's events."""

import json

import cv2
import numpy as np
import pytest
import torch

from evr_tpu.parallel import get_mesh as jget_mesh
from evr_tpu.parallel.mesh import get_multislice_mesh as jget_multislice_mesh
from evr_tpu_torch.config import DataRootConfig
from evr_tpu_torch.index import EmbeddingEngine
from evr_tpu_torch.index.store import FrameIndex
from evr_tpu_torch.parallel import get_mesh, get_multislice_mesh, local_device_count
from evr_tpu_torch.parallel.mesh import pad_to_multiple, replicated, shard_rows
from evr_tpu_torch.serving import ServingContext
from torch_threads import one_torch_thread  # noqa: F401

TINY = "ViT-Tiny-Test"


def test_mesh_shapes():
    """Shapes as JAX's meshes have them; slots cycle over the local devices."""
    for n in (8, 4):
        mesh, jmesh = get_mesh(n, device="cpu"), jget_mesh(n)
        assert mesh.shape == dict(jmesh.shape) == {"data": n}
        assert mesh.size == n and mesh.local_slots == list(range(n))
        assert mesh.local_devices == [torch.device("cpu")]
    mesh2 = get_mesh(8, axis_names=("data", "model"), shape=(4, 2), device="cpu")
    jmesh2 = jget_mesh(8, axis_names=("data", "model"), shape=(4, 2))
    assert mesh2.shape == dict(jmesh2.shape) == {"data": 4, "model": 2}
    assert shard_rows(mesh2).spec == ("data",) and replicated(mesh2).spec == ()
    assert shard_rows(mesh2).shard_shape((12, 3)) == (3, 3)
    assert pad_to_multiple(10, 4) == 12 and pad_to_multiple(12, 4) == 12
    with pytest.raises(ValueError):
        get_mesh(8, shape=(3, 2), axis_names=("data", "model"), device="cpu")


def test_slots_come_from_the_card_or_the_cpu_on_request(monkeypatch):
    """No card: a mesh raises unless the caller asks for the CPU, whose slot
    count is ``EVR_TPU_CPU_DEVICES`` (1 by default); the multi-slice layout
    needs the slots it names, as JAX's does."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            get_mesh()
    monkeypatch.delenv("EVR_TPU_CPU_DEVICES", raising=False)
    assert get_mesh(device="cpu").size == 1
    monkeypatch.setenv("EVR_TPU_CPU_DEVICES", "8")
    assert local_device_count("cpu") == 8 and get_mesh(device="cpu").size == 8
    mesh = get_multislice_mesh(2, 4, device="cpu")
    assert mesh.shape == dict(jget_multislice_mesh(2, 4).shape) == {"replica": 2, "data": 4}
    with pytest.raises(ValueError):
        get_multislice_mesh(4, 4, device="cpu")


@pytest.mark.parametrize("params_dtype", ["float32", "int8"])
def test_mesh_engine_matches_single_device(params_dtype):
    """``tests/test_mesh_engine.py::test_mesh_engine_matches_single_device``:
    staged frames and texts through an 8-slot engine equal the one-device
    engine's rows (int8 weights too: each row is quantised on its own)."""
    single = EmbeddingEngine(TINY, batch_size=8, device="cpu", params_dtype=params_dtype)
    sharded = EmbeddingEngine(TINY, batch_size=8, device="cpu", params_dtype=params_dtype,
                              mesh=get_mesh(8, device="cpu"))
    staged = (np.random.default_rng(0).random((11, 64, 64, 3)) * 255).astype(np.uint8)
    np.testing.assert_allclose(sharded.encode_staged_images(staged), single.encode_staged_images(staged),
                               rtol=1e-5, atol=1e-6)
    texts = ["hello world", "a cat", "dog", "bird", "x", "y", "z", "w", "one more"]
    np.testing.assert_allclose(sharded.encode_texts(texts), single.encode_texts(texts), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(sharded.encode_texts("a query alone"), single.encode_texts("a query alone"),
                               rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="must divide evenly"):
        EmbeddingEngine(TINY, batch_size=6, device="cpu", mesh=get_mesh(4, device="cpu"))


def _write_video(path, n=40, size=64):
    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 25.0, (size, size))
    for i in range(n):
        f = np.zeros((size, size, 3), np.uint8)  # a new scene every 5 frames
        f[:, :, (i // 5) % 3] = 60 + 24 * (i // 5)
        f[::7, ::5, (i // 5 + 1) % 3] = 255
        w.write(f)
    w.release()


@pytest.fixture(scope="module")
def ingested_root(tmp_path_factory):
    """``tests/test_mesh_engine.py::test_sharded_serving_context``'s video,
    ingested through a context over a 4-slot mesh."""
    tmp = tmp_path_factory.mktemp("meshroot")
    _write_video(tmp / "v.mp4")
    mesh = get_mesh(4, device="cpu")
    ctx = ServingContext(DataRootConfig(tmp / "data"),
                         engine=EmbeddingEngine(TINY, batch_size=8, device="cpu", mesh=mesh), mesh=mesh)
    ctx.ingest(tmp / "v.mp4")
    return tmp / "data", ctx


def test_sharded_serving_context(ingested_root):
    """Ingest and every exact search path over the sharded index give the
    unsharded context's results on the same data root."""
    root, ctx = ingested_root
    assert ctx.mesh.size == 4 and ctx.index.mesh is ctx.mesh
    plain = ServingContext(DataRootConfig(root), engine=EmbeddingEngine(TINY, batch_size=8, device="cpu"))
    plain.boot()
    got = ctx.query_engine.query_text_clip("red scene", top_k=2)
    ref = plain.query_engine.query_text_clip("red scene", top_k=2)
    assert len(got) == 2 and all(np.isfinite(r["clip_similarity"]) for r in got)
    assert [(r["videoId"], r["id"]) for r in got] == [(r["videoId"], r["id"]) for r in ref]
    for g, r in zip(got, ref):
        assert abs(g["clip_similarity"] - r["clip_similarity"]) <= 1e-5


def test_shard_index_cli_boots_and_serves(ingested_root, monkeypatch, capsys):
    """``python -m evr_tpu_torch.serving --shard-index`` over the default
    mesh (``EVR_TPU_CPU_DEVICES=4`` CPU slots): the mesh reaches the engine
    and the index, and six ``/api/search`` requests return the unsharded
    server's events."""
    import werkzeug.serving
    from werkzeug.test import Client

    from evr_tpu_torch.serving.__main__ import main

    root, _ = ingested_root
    apps = {}
    monkeypatch.setattr(werkzeug.serving, "run_simple", lambda host, port, app, **kw: apps.setdefault(port, app))
    base = ["--data-root", str(root), "--device", "cpu", "--model", TINY, "--batch-size", "8"]
    monkeypatch.setenv("EVR_TPU_CPU_DEVICES", "4")
    main(base + ["--port", "1", "--shard-index"])
    assert "sharding over {'data': 4} mesh" in capsys.readouterr().out
    main(base + ["--port", "2"])
    sharded, plain = Client(apps[1]), Client(apps[2])
    bodies = [{"search_method": "text_clip", "query": q, "top_k": k}
              for q, k in (("red scene", 5), ("blue scene", 3), ("a car", 7))]
    bodies += [{"query": "a person", "top_k": 4, "adaptive_threshold": -1.0},
               {"search_method": "text_clip", "query": "a dog", "top_k": 5, "mmr_lambda": 0.5},
               {"search_method": "text_clip", "query": "a dog", "top_k": 5, "negative_query": "a cat"}]
    for body in bodies:
        got = json.loads(sharded.post("/api/search", json={"search_type": "text", **body}).data)["events"]
        ref = json.loads(plain.post("/api/search", json={"search_type": "text", **body}).data)["events"]
        assert [(e["videoId"], e["id"]) for e in got] == [(e["videoId"], e["id"]) for e in ref], body
        assert len(got) > 0


def test_frame_index_mesh_layout_and_refusals():
    """Rows padded as the JAX package pads them under a mesh (whole 128-row
    tiles a shard); the int8 × ivf × mesh refusal is JAX's; the ANN tiers
    under a mesh build a sub-index a shard (``tests/test_torch_sharded_ann.py``
    holds them to JAX's)."""
    from evr_tpu.index.store import FrameIndex as JFrameIndex

    mesh, jmesh = get_mesh(4, device="cpu"), jget_mesh(4)
    for n in (0, 1, 300, 512, 513, 1500):
        assert FrameIndex(embed_dim=8, mesh=mesh)._padded_rows(n) == \
            JFrameIndex(embed_dim=8, mesh=jmesh)._padded_rows(n), n
    with pytest.raises(ValueError, match="mesh-sharded IVF"):
        FrameIndex(embed_dim=8, mesh=mesh, search_impl="ivf", device_dtype="int8")
    rows = np.random.default_rng(0).standard_normal((64, 8)).astype(np.float32)
    for impl in ("ivf", "ivfpq"):
        ann = FrameIndex(embed_dim=8, mesh=mesh, search_impl=impl, ivf_clusters=4, ivf_nprobe=4)
        ann.add_video("v", rows)
        s, r = ann.search_raw(rows[:2], 3)
        assert type(ann._ivf).__name__.startswith("Sharded") and (r[:, 0] == [0, 1]).all()
    ix = FrameIndex(embed_dim=8, mesh=mesh)
    assert ix.device == torch.device("cpu") and ix.mesh_axis == "data"
