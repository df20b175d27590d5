"""The PyTorch port's frame index and registry against the JAX package.

Same embeddings (numpy, seeded) into both packages on the CPU. Tolerance:
scores within 1e-5 (the JAX retrieval tests' top-k bound), row indices
identical. Each package loads the index the other saved.
"""

import json

import numpy as np
import pytest
import torch

from evr_tpu.index.store import FrameIndex as JIndex, VideoRegistry as JRegistry
from evr_tpu_torch.index.store import FrameIndex as TIndex, VideoRegistry as TRegistry

SCORE_TOL = 1e-5
D = 32


def _videos():
    rng = np.random.default_rng(5)
    return {
        f"vid{v}": rng.standard_normal((n, D)).astype(np.float32)
        for v, n in enumerate((40, 7, 25))
    }


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_frame_index_search_matches_jax(dtype):
    vids = _videos()
    j, t = JIndex(embed_dim=D, device_dtype=dtype), TIndex(embed_dim=D, device_dtype=dtype, device="cpu")
    for name, emb in vids.items():
        names = [f"{i * 5}.jpg" for i in range(len(emb))]
        j.add_video(name, emb, names)
        t.add_video(name, emb, names)
    q = np.random.default_rng(6).standard_normal((4, D)).astype(np.float32)
    for video in (None, "vid1", "vid2"):
        jh, th = j.search(q, 12, video), t.search(q, 12, video)
        for a, b in zip(jh, th):
            assert [(h.video, h.frame_name, h.row, h.frame_index) for h in a] == [
                (h.video, h.frame_name, h.row, h.frame_index) for h in b
            ]
            np.testing.assert_allclose([h.score for h in b], [h.score for h in a], atol=SCORE_TOL)
    assert t.total_frames == j.total_frames == 72
    assert t.resolve_row(45) == j.resolve_row(45)
    np.testing.assert_allclose(t.get_embeddings("vid2"), j.get_embeddings("vid2"))


def test_frame_index_append_and_remove_match_jax():
    vids = _videos()
    j, t = JIndex(embed_dim=D), TIndex(embed_dim=D, device="cpu")
    for idx in (j, t):
        idx.add_video("vid0", vids["vid0"])
        idx.build()
        v0 = idx.version
        idx.add_video("vid1", vids["vid1"])  # appended in place, no rebuild
        assert not idx._dirty and idx.version == v0 + 1
        idx.add_video("vid2", vids["vid2"])
        idx.remove_video("vid1")
    q = np.random.default_rng(7).standard_normal((2, D)).astype(np.float32)
    js, jr = j.search_raw(q, 9)
    ts, tr = t.search_raw(q, 9)
    np.testing.assert_array_equal(tr, jr)
    np.testing.assert_allclose(ts, js, atol=SCORE_TOL)
    assert t.videos == j.videos == ["vid0", "vid2"]


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_save_load_across_packages(tmp_path, direction):
    vids = _videos()
    writer = JIndex(embed_dim=D) if direction == "jax_to_torch" else TIndex(embed_dim=D, device="cpu")
    for name, emb in vids.items():
        writer.add_video(name, emb, [f"{i}.jpg" for i in range(len(emb))])
    writer.save(tmp_path)
    reader = (
        TIndex.load(tmp_path, embed_dim=D, device="cpu")
        if direction == "jax_to_torch"
        else JIndex.load(tmp_path, embed_dim=D)
    )
    assert sorted(reader.videos) == sorted(vids)
    for name, emb in vids.items():
        np.testing.assert_array_equal(reader.get_embeddings(name, normalised=False), emb)
        assert reader.frame_names(name) == [f"{i}.jpg" for i in range(len(emb))]
    q = np.random.default_rng(8).standard_normal((2, D)).astype(np.float32)
    np.testing.assert_array_equal(reader.search_raw(q, 5)[1], writer.search_raw(q, 5)[1])


def test_registry_round_trips_across_packages(tmp_path):
    path = tmp_path / "metadata" / "video_mapping.json"
    reg = TRegistry(path)
    reg.add("a", video_path="videos/a.mp4", embeddings_file="embedding/a_embeddings.npy",
            embedding_model="original")
    with pytest.raises(KeyError):
        reg.add("b", bogus="x")
    assert JRegistry(path).get("a") == reg.get("a")
    (tmp_path / "videos").mkdir()
    (tmp_path / "videos" / "a.mp4").write_bytes(b"0")
    JRegistry(path).add("gone", video_path="videos/gone.mp4")
    reg = TRegistry(path)
    assert reg.prune_missing(tmp_path) == ["gone"]
    assert json.loads(path.read_text()).keys() == {"a"}


def test_index_needs_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TIndex(embed_dim=D)
