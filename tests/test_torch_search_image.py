"""Image and hybrid search on the port against the JAX package, and the
port's image decode against PIL's.

The port decodes query images with cv2 (the card's machine is not known to
have PIL); ``decode_image`` must read PNG exactly as PIL's
``Image.open(...).convert("RGB")`` does (RGB, RGBA, grey, palette) and JPEG
within JPEG_TOL levels (two libjpeg builds), EXIF orientation not applied in
either. Over one data root (``torch_route_root``: both indexes hold the JAX
engine's rows of the decoded frames), an indexed frame sent as base64 must be
its own top-1 through the port's ``ImageSearcher``, and the events of image
and hybrid requests must equal the JAX app's: frames exactly, scores within
SCORE_TOL (each package encodes the query itself, in fp32).
"""

import base64
import io

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
Image = pytest.importorskip("PIL.Image")
pytest.importorskip("werkzeug")

from torch_route_root import build_pair, ids, payload, same_events

from evr_tpu_torch.serving.context import decode_image

SCORE_TOL = 1e-4
JPEG_TOL = 2


def _encoded(img, fmt, **kwargs):
    buf = io.BytesIO()
    img.save(buf, format=fmt, **kwargs)
    return buf.getvalue()


def _pil_rgb(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def test_png_decode_equals_pil():
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    alpha = rng.integers(0, 256, (37, 53, 1), dtype=np.uint8)
    images = [Image.fromarray(rgb), Image.fromarray(np.concatenate([rgb, alpha], 2), "RGBA"),
              Image.fromarray(rgb[:, :, 0]), Image.fromarray(rgb).convert("P")]
    for img in images:
        data = _encoded(img, "PNG")
        got = decode_image(data)
        assert got.dtype == np.uint8 and got.shape == (37, 53, 3), img.mode
        assert np.array_equal(got, _pil_rgb(data)), img.mode


def test_jpeg_decode_within_tolerance_of_pil():
    rng = np.random.default_rng(1)
    rgb = cv2.GaussianBlur(rng.integers(0, 256, (64, 80, 3), dtype=np.uint8), (5, 5), 0)
    exif = Image.Exif()
    exif[0x0112] = 6  # "rotate 90": neither decoder applies it
    for img, kwargs in ((Image.fromarray(rgb), {"quality": 90}), (Image.fromarray(rgb[:, :, 1]), {}),
                        (Image.fromarray(rgb), {"exif": exif.tobytes()})):
        data = _encoded(img, "JPEG", **kwargs)
        got, ref = decode_image(data), _pil_rgb(data)
        assert got.shape == ref.shape == (64, 80, 3)
        assert int(np.abs(got.astype(int) - ref).max()) <= JPEG_TOL
    with pytest.raises(ValueError):
        decode_image(b"not an image")


@pytest.fixture(scope="module")
def clients(tmp_path_factory):
    return build_pair(tmp_path_factory.mktemp("image_search"))


def test_load_image_source_forms(clients, tmp_path):
    jc, tc, frames = clients
    jctx, tctx = jc.application.ctx, tc.application.ctx
    path = frames["clipB"][0][3]
    raw = path.read_bytes()
    for source in (str(path), base64.b64encode(raw).decode(),
                   "data:image/jpeg;base64," + base64.b64encode(raw).decode()):
        got, ref = tctx.load_image_source(source), np.asarray(jctx.load_image_source(source))
        assert got.shape == ref.shape and int(np.abs(got.astype(int) - ref).max()) <= JPEG_TOL
    # base64 whose run between slashes passes a file name's 255 bytes: the JAX
    # package's Path.exists raises (an HTTP 500); the port reads it as base64
    png = _encoded(Image.fromarray(frames["clipA"][1][0]), "PNG")
    long_b64 = base64.b64encode(png).decode()
    assert max(len(part) for part in long_b64.split("/")) > 255
    assert np.array_equal(tctx.load_image_source(long_b64), frames["clipA"][1][0])
    with pytest.raises(OSError):
        jctx.load_image_source(long_b64)
    for source in ("https://example.com/x.jpg", "%%%not-base64", str(tmp_path / "missing.jpg")):
        with pytest.raises(ValueError) as t_err:
            tctx.load_image_source(source)
        with pytest.raises(ValueError) as j_err:
            jctx.load_image_source(source)
        assert str(t_err.value) == str(j_err.value)


def _request(jc, tc, body):
    jr, tr = jc.post("/api/search", json=body), tc.post("/api/search", json=body)
    assert tr.status_code == jr.status_code, (tr.status_code, jr.status_code)
    return payload(jr), payload(tr)


def test_image_search_matches_jax(clients):
    jc, tc, frames = clients
    picks = [("clipA", 0), ("clipA", 17), ("clipB", 4), ("clipC", 12)]
    for video, i in picks:
        image = base64.b64encode(frames[video][0][i].read_bytes()).decode()
        for extra in ({}, {"videoId": "video-3"}, {"adaptive_threshold": 0.2}):
            body = {"search_type": "image", "image_url": image, "top_k": 6, "adaptive_threshold": -1.0, **extra}
            j, t = _request(jc, tc, body)
            same_events(t["events"], j["events"], "clip_similarity", SCORE_TOL)
            if not extra:
                top = t["events"][0]
                assert (top["videoId"], top["id"]) == (f"video-{video}", f"event-{i * 5}")
                assert top["clip_similarity"] > 0.999
    # the route's launches: one ImageSearcher dispatch per request
    searcher = tc.application.ctx.image_searcher
    calls, real = [], searcher.search
    searcher.search = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        image = base64.b64encode(frames["clipC"][0][1].read_bytes()).decode()
        tc.post("/api/search", json={"search_type": "image", "image_url": image, "top_k": 3})
    finally:
        searcher.search = real
    assert calls == [1]


def test_hybrid_search_matches_jax(clients):
    jc, tc, frames = clients
    image = base64.b64encode(frames["clipA"][0][5].read_bytes()).decode()
    for weight, query in ((0.5, "a red car"), (0.9, "đánh nhau trên đường"), (0.0, "a dog")):
        body = {"search_type": "hybrid", "image_url": image, "query": query, "image_weight": weight,
                "top_k": 5, "adaptive_threshold": -1.0}
        j, t = _request(jc, tc, body)
        assert t["events"]
        same_events(t["events"], j["events"], "clip_similarity", SCORE_TOL)
    # the query image encodes alone: one row, not a batch padded with zeros
    import evr_tpu_torch.index.engine as engine_module

    rows, real = [], engine_module.encode_staged_u8
    engine_module.encode_staged_u8 = lambda p, c, x, **k: rows.append(len(x)) or real(p, c, x, **k)
    try:
        j, t = _request(jc, tc, {**body, "image_weight": 1.0})
    finally:
        engine_module.encode_staged_u8 = real
    assert rows == [1]
    assert ids(t["events"])[0] == ("video-clipA", "event-25")
    for bad in ({"search_type": "hybrid", "query": "x"},
                {"search_type": "hybrid", "image_url": "https://x/y.jpg", "query": "x"},
                {"search_type": "image", "image_url": "???"},
                {"search_type": "hybrid", "image_url": image, "query": "x", "image_weight": 2}):
        j, t = _request(jc, tc, bad)
        assert t == j and "error" in t, bad
