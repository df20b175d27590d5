"""HTTP API on a werkzeug WSGI app: the JAX app's routes, on the port.

Counterpart of ``evr_tpu/serving/app.py``, with the same routes, request
validation and response payloads: the built-in UI (``/``) and a built SPA
(``/app/``), the video list and each video's events, ``/api/search`` with
every method of ``SEARCH_METHODS`` plus ``temporal`` and the ``image`` and
``hybrid`` search types, frame and video files (HTTP Range, no path outside
the data root), voice transcription, the cached UMAP view, available videos,
the models and the active model, stats and health, and the upload of a
video: ``POST /api/upload-video`` saves the file and queues its ingest as a
background job (202 and a job id; ``sync=1`` waits and answers with the
result), ``GET /api/upload-status/<job_id>`` reports the job's stage.

Run: ``python -m evr_tpu_torch.serving --data-root data --port 5000``.
"""

from __future__ import annotations

import json
import pathlib
import time

from werkzeug.exceptions import HTTPException, NotFound
from werkzeug.routing import Map, RequestRedirect, Rule
from werkzeug.utils import secure_filename
from werkzeug.wrappers import Request, Response

from evr_tpu_torch.query.events import format_event_for_frontend
from evr_tpu_torch.utils import Timer

from .context import ServingContext


def _json(payload, status: int = 200) -> Response:
    resp = Response(
        json.dumps(payload, ensure_ascii=False), status=status, mimetype="application/json"
    )
    resp.headers["Access-Control-Allow-Origin"] = "*"
    resp.headers["Access-Control-Allow-Headers"] = "Content-Type"
    resp.headers["Access-Control-Allow-Methods"] = "GET, POST, OPTIONS"
    return resp


def _file(path, mimetype: str, environ) -> Response:
    """A file with HTTP Range and conditional support (werkzeug's
    ``send_file``): 206 + Content-Range for a partial request (a ``<video>``
    seeking), ETag/304 revalidation, and Accept-Ranges on full 200s too."""
    from werkzeug.exceptions import RequestedRangeNotSatisfiable
    from werkzeug.utils import send_file

    try:
        resp = send_file(pathlib.Path(path), environ, mimetype=mimetype, conditional=True)
    except RequestedRangeNotSatisfiable as e:
        resp = e.get_response(environ)
    resp.headers.setdefault("Accept-Ranges", "bytes")
    resp.headers["Access-Control-Allow-Origin"] = "*"
    return resp


def _search_request(data: dict):
    """Validate a search body as the JAX app does; returns (fields, None) or
    (None, error response)."""
    search_type = data.get("search_type", "text")
    query = data.get("query", "")
    image_url = data.get("image_url")
    try:
        top_k = int(data.get("top_k", 10))
        adaptive_threshold = float(data.get("adaptive_threshold", 0.5))
        text_confidence = float(data.get("text_confidence", adaptive_threshold))
        object_confidence = float(data.get("object_confidence", adaptive_threshold))
    except (TypeError, ValueError):
        return None, _json({"error": "top_k / threshold fields must be numeric"}, 400)
    mmr_lambda = data.get("mmr_lambda")
    if mmr_lambda is not None:
        try:
            mmr_lambda = float(mmr_lambda)
        except (TypeError, ValueError):
            return None, _json({"error": "mmr_lambda must be numeric"}, 400)
        if not 0.0 <= mmr_lambda <= 1.0:
            return None, _json({"error": "mmr_lambda must be in [0, 1]"}, 400)
    negative_query = data.get("negative_query")
    if negative_query is not None and not isinstance(negative_query, str):
        return None, _json({"error": "negative_query must be a string"}, 400)
    try:
        negative_weight = float(data.get("negative_weight", 0.8))
    except (TypeError, ValueError):
        return None, _json({"error": "negative_weight must be numeric"}, 400)
    if not 0.0 <= negative_weight <= 10.0:
        return None, _json({"error": "negative_weight must be in [0, 10]"}, 400)
    try:
        image_weight = float(data.get("image_weight", 0.5))
    except (TypeError, ValueError):
        return None, _json({"error": "image_weight must be numeric"}, 400)
    if not 0.0 <= image_weight <= 1.0:
        return None, _json({"error": "image_weight must be in [0, 1]"}, 400)
    search_method = data.get("search_method", "text")
    keyword = data.get("keyword", "")
    object_keyword = data.get("object", "")
    enable_clip_similarity = data.get("enableClipSimilarity", False)
    model_name = data.get("model", "original")
    for field, v in (
        ("search_type", search_type), ("query", query),
        ("search_method", search_method), ("keyword", keyword),
        ("object", object_keyword), ("model", model_name),
    ):
        if not isinstance(v, str):
            return None, _json({"error": f"{field} must be a string"}, 400)
    if image_url is not None and not isinstance(image_url, str):
        return None, _json({"error": "image_url must be a string"}, 400)
    method = "text_adaptive" if search_method == "text" else search_method
    if mmr_lambda is not None and method not in ("text_clip", "text_adaptive"):
        return None, _json(
            {"error": "mmr_lambda is only supported for text_clip/text_adaptive"}, 400
        )
    if negative_query and method != "text_clip":
        return None, _json({"error": "negative_query is only supported for text_clip"}, 400)
    queries_list = data.get("queries")
    max_gap = data.get("max_gap")
    if search_method == "temporal":
        if (
            not isinstance(queries_list, list)
            or len(queries_list) < 2
            or not all(isinstance(q, str) and q for q in queries_list)
        ):
            return None, _json(
                {"error": "temporal search needs 'queries': a list of >= 2 non-empty strings"},
                400,
            )
        if max_gap is not None:
            try:
                max_gap = int(max_gap)
            except (TypeError, ValueError):
                return None, _json({"error": "max_gap must be an integer"}, 400)
    return {
        "search_type": search_type, "query": query, "image_url": image_url,
        "top_k": top_k, "adaptive_threshold": adaptive_threshold,
        "text_confidence": text_confidence, "object_confidence": object_confidence,
        "mmr_lambda": mmr_lambda, "negative_query": negative_query,
        "negative_weight": negative_weight, "image_weight": image_weight,
        "search_method": search_method, "method": method, "keyword": keyword,
        "object": object_keyword, "enable_clip_similarity": bool(enable_clip_similarity),
        "model": model_name, "queries": tuple(queries_list or ()), "max_gap": max_gap,
    }, None


def create_app(ctx: ServingContext, frontend_dist: str | None = None):
    """``frontend_dist``: optional directory of a built SPA served at
    ``/app/``; the JSON API stays under ``/api/``."""
    url_map = Map(
        [
            Rule("/", endpoint="index", methods=["GET"]),
            Rule("/app/", endpoint="frontend", defaults={"asset": "index.html"}, methods=["GET"]),
            Rule("/app/<path:asset>", endpoint="frontend", methods=["GET"]),
            Rule("/api/videos", endpoint="videos", methods=["GET"]),
            Rule("/api/video/<video_id>/events", endpoint="video_events", methods=["GET"]),
            Rule("/api/search", endpoint="search", methods=["POST"]),
            Rule("/api/upload-video", endpoint="upload", methods=["POST"]),
            Rule("/api/upload-status/<job_id>", endpoint="upload_status", methods=["GET"]),
            Rule("/api/frame/<path:frame_path>", endpoint="frame", methods=["GET"]),
            Rule("/api/video/<path:video_path>", endpoint="video_file", methods=["GET"]),
            Rule("/api/transcribe-voice", endpoint="transcribe", methods=["POST"]),
            Rule("/api/visualization/umap", endpoint="umap", methods=["POST"]),
            Rule("/api/videos/available", endpoint="available", methods=["GET"]),
            Rule("/health", endpoint="health", methods=["GET"]),
            Rule("/api/models", endpoint="models", methods=["GET"]),
            Rule("/api/models/active", endpoint="active_model", methods=["GET", "POST"]),
            Rule("/api/stats", endpoint="stats", methods=["GET"]),
        ]
    )

    def ep_health(request):
        return _json({"status": "ok"})

    def ep_index(request):
        from .ui import INDEX_HTML

        resp = Response(INDEX_HTML, mimetype="text/html")
        resp.headers["Access-Control-Allow-Origin"] = "*"
        return resp

    def ep_frontend(request, asset):
        import mimetypes

        if frontend_dist is None:
            return _json({"error": "no frontend dist configured (--frontend-dist)"}, 404)
        root = pathlib.Path(frontend_dist).resolve()
        target = (root / asset).resolve()
        if not target.is_relative_to(root):
            return _json({"error": "not found"}, 404)
        if not target.is_file():
            # SPA fallback: unknown client-side routes serve index.html
            target = root / "index.html"
            if not target.is_file():
                return _json({"error": "not found"}, 404)
        mimetype = mimetypes.guess_type(str(target))[0] or "application/octet-stream"
        return _file(target, mimetype, request.environ)

    def ep_videos(request):
        ctx.prune_missing()
        videos = []
        for idx, name in enumerate(ctx.video_names(), 1):
            summary = ctx.video_summary(idx, name)
            if summary is not None:
                videos.append(summary)
        return _json(videos)

    def ep_video_events(request, video_id):
        name = ctx.video_name_from_id(video_id)
        if name is None:
            return _json({"error": f"Video with ID {video_id} not found"}, 404)
        fps = ctx.metadata.fps(name)
        events = [format_event_for_frontend(fr.raw, fps=fps) for fr in ctx.metadata.frames(name)]
        if len(events) > 20:  # at most 20 timeline markers
            step = len(events) // 20
            events = [events[i] for i in range(0, len(events), step)][:20]
        return _json(events)

    def ep_stats(request):
        return _json(
            {
                "timings": Timer.report(),
                "index": {
                    "videos": sum(len(i.videos) for i in ctx._indexes.values()),
                    "frames": sum(i.total_frames for i in ctx._indexes.values()),
                    "per_model": {
                        m: {"videos": len(i.videos), "frames": i.total_frames}
                        for m, i in ctx._indexes.items()
                    },
                    "version": ctx.index.version,
                },
                "caches": {"search": len(ctx.search_cache), "viz": len(ctx.viz_cache)},
                "active_model": ctx.engine.active_model,
            }
        )

    def _strategy(qe, req, video_name):
        """The text search types' strategy call; "text", the default label,
        and any unknown method fall back to text_adaptive, as in the JAX app."""
        query, top_k, method = req["query"], req["top_k"], req["search_method"]
        keyword = req["keyword"] or query
        obj = req["object"] or query
        threshold = req["adaptive_threshold"]
        if method == "text_clip":
            return qe.query_text_clip(
                query, top_k, video_name, mmr_lambda=req["mmr_lambda"],
                negative_query=req["negative_query"], negative_weight=req["negative_weight"])
        if method == "video":
            return qe.query_videos(query, top_k=top_k, video_name=video_name)
        if method == "keyword_only":
            return qe.query_keyword(keyword, req["text_confidence"], top_k, video_name)
        if method == "text_keyword":
            return qe.query_text_keyword(query, threshold, top_k, keyword=keyword,
                                         text_confidence=req["text_confidence"],
                                         video_name=video_name)
        if method == "object_only":
            return qe.query_object(obj, req["object_confidence"], top_k, video_name)
        if method == "text_object":
            return qe.query_text_object(query, threshold, top_k, object_keyword=obj,
                                        object_confidence=req["object_confidence"],
                                        video_name=video_name)
        if method == "text_object_keyword":
            return qe.query_text_object_keyword(
                query, threshold, top_k, keyword=keyword, text_confidence=req["text_confidence"],
                object_keyword=obj, object_confidence=req["object_confidence"],
                video_name=video_name)
        if method == "speech_only":
            return qe.query_speech(keyword, top_k, video_name)
        if method == "text_speech":
            return qe.query_text_speech(query, threshold, top_k, keyword=keyword,
                                        video_name=video_name)
        return qe.query_text_adaptive(query, threshold, top_k, video_name,
                                      mmr_lambda=req["mmr_lambda"])

    def ep_search(request):
        start_time = time.time()
        data = request.get_json(silent=True) or {}
        if not isinstance(data, dict):
            return _json({"error": "request body must be a JSON object"}, 400)
        req, error = _search_request(data)
        if error is not None:
            return error
        if req["model"] != ctx.engine.active_model:
            ctx.engine.set_active_model(req["model"])
        video_name = ctx.video_name_from_id(data.get("videoId") or "")

        # result cache keyed by the request semantics + index version
        ctx.index._ensure_built()
        cache_key = (ctx.engine.active_model, ctx.index.version, video_name) + tuple(
            req[k] for k in sorted(req)
        )
        cached = ctx.search_cache.get(cache_key)
        if cached is not None:
            return _json(cached)

        search_type, image_url, top_k = req["search_type"], req["image_url"], req["top_k"]
        threshold = req["adaptive_threshold"]
        results: list[dict] = []
        try:
            if search_type == "image" and image_url:
                results = ctx.search_by_image(image_url, threshold, top_k, video_name)
            elif search_type == "hybrid":
                if not (image_url and req["query"]):
                    return _json({"error": "hybrid search needs both image_url and query"}, 400)
                results = ctx.search_hybrid(image_url, req["query"], req["image_weight"],
                                            threshold, top_k, video_name)
        except ValueError as e:
            return _json({"error": str(e)}, 400)
        if search_type == "text" and req["search_method"] == "temporal":
            results = ctx.query_engine.query_temporal(
                list(req["queries"]), top_k=top_k, max_gap=req["max_gap"], video_name=video_name)
        elif search_type == "text" and req["query"]:
            results = _strategy(ctx.query_engine, req, video_name)

        for r in results:
            r.setdefault("text_confidence", 0.0)
            r.setdefault("object_confidence", 0.0)
            r.setdefault("clip_similarity", 0.0)
        if video_name:
            results = [
                r
                for r in results
                if video_name in (r.get("videoId") or "")
                or (r.get("videoId") or "").endswith(video_name)
            ]
        if (
            search_type in ("image", "hybrid")
            or req["search_method"] in ("text_clip", "text_adaptive")
            or req["enable_clip_similarity"]
        ):
            results.sort(key=lambda x: x.get("clip_similarity", 0), reverse=True)
        else:
            results.sort(key=lambda x: x.get("confidence", 0), reverse=True)
        Timer.record(f"search/{req['search_method']}", time.time() - start_time)
        payload = {"events": results[:top_k]}
        ctx.search_cache.set(cache_key, payload)
        return _json(payload)

    def ep_upload(request):
        """Asynchronous by default: the request saves the file and queues a
        background ingest job, answering 202 and the job id; the form field
        ``sync=1`` waits for the job and answers with its payload."""
        video_file = request.files.get("video")
        if not video_file:
            return _json({"error": "No video uploaded"}, 400)
        filename = secure_filename(video_file.filename or "upload.mp4")
        video_name = pathlib.Path(filename).stem
        save_dir = ctx.data_root.video_dir / video_name
        save_dir.mkdir(parents=True, exist_ok=True)
        save_path = save_dir / filename
        video_file.save(str(save_path))

        model_name = request.form.get("model", "original")
        if model_name != ctx.engine.active_model:
            ctx.engine.set_active_model(model_name)

        def run_ingest(progress):
            result = ctx.ingest(save_path, video_name, progress=progress)
            return ctx.upload_payload(save_path, video_name, model_name, result)

        job_id = ctx.ingest_jobs.submit(video_name, run_ingest)
        if request.form.get("sync", "").lower() in ("1", "true", "yes"):
            job = ctx.ingest_jobs.wait(job_id)
            if job.state == "error":
                return _json({"error": f"Ingest failed: {job.error}"}, 500)
            return _json(job.result)
        return _json(
            {
                "status": "processing",
                "job_id": job_id,
                "video_name": video_name,
                "status_url": f"/api/upload-status/{job_id}",
            },
            202,
        )

    def ep_upload_status(request, job_id):
        status = ctx.ingest_jobs.status(job_id)
        if status is None:
            return _json({"error": f"Unknown upload job {job_id}"}, 404)
        return _json(status)

    def _safe_under_data_root(candidate: pathlib.Path) -> bool:
        """Only files under the data root are served (no path traversal)."""
        try:
            resolved = candidate.resolve()
        except OSError:
            return False
        return resolved.is_file() and resolved.is_relative_to(ctx.data_root.root.resolve())

    def ep_frame(request, frame_path):
        candidate = pathlib.Path(frame_path)
        if _safe_under_data_root(candidate):
            return _file(candidate.resolve(), "image/jpeg", request.environ)
        # PureWindowsPath splits on / and \: metadata may carry Windows paths
        frame_name = pathlib.PureWindowsPath(frame_path).name
        for name in ctx.video_names():
            frames_dir = (ctx.registry.get(name) or {}).get("frames_dir")
            if frames_dir:
                base = ctx.resolve_path(frames_dir)
                p = (base / frame_name).resolve()
                if p.is_file() and p.parent == base.resolve():
                    return _file(p, "image/jpeg", request.environ)
        return _json({"error": f"Frame {frame_path} not found"}, 404)

    def ep_video_file(request, video_path):
        candidate = pathlib.Path(video_path)
        if _safe_under_data_root(candidate):
            return _file(candidate.resolve(), "video/mp4", request.environ)
        base = pathlib.PureWindowsPath(video_path).name
        for name in ctx.video_names():
            vp = (ctx.registry.get(name) or {}).get("video_path", "")
            if name == base or pathlib.Path(vp).name == base:
                resolved = ctx.resolve_path(vp) if vp else None
                if resolved is not None and resolved.exists():
                    return _file(resolved, "video/mp4", request.environ)
        return _json({"error": f"Video {video_path} not found"}, 404)

    def ep_transcribe(request):
        if "audio" not in request.files:
            return _json({"error": "No audio file provided"}, 400)
        audio = request.files["audio"]
        if not audio.filename:
            return _json({"error": "No audio file selected"}, 400)
        if ctx.transcriber is None:
            return _json({"error": "no transcription backend configured on this deployment"}, 501)
        language = request.form.get("language", "en_us")
        tmp_name = secure_filename(f"voice_{int(time.time())}.audio")
        tmp_path = ctx.data_root.root / "voice" / tmp_name
        tmp_path.parent.mkdir(parents=True, exist_ok=True)
        audio.save(str(tmp_path))
        try:
            text = ctx.transcriber(str(tmp_path), language)
        except Exception as e:
            return _json({"error": f"Transcription failed: {e}"}, 500)
        return _json({"text": text, "audio_file": tmp_name})

    def ep_umap(request):
        from evr_tpu_torch.viz import generate_visualization

        data = request.get_json(silent=True) or {}
        if not isinstance(data, dict):
            return _json({"error": "request body must be a JSON object"}, 400)
        video_names = data.get("video_names")
        if video_names is not None and (
            not isinstance(video_names, list) or not all(isinstance(v, str) for v in video_names)
        ):
            return _json({"error": "video_names must be a list of strings"}, 400)
        try:
            n_neighbors = int(data.get("n_neighbors", 15))
            min_dist = float(data.get("min_dist", 0.1))
        except (TypeError, ValueError):
            return _json({"error": "n_neighbors/min_dist must be numeric"}, 400)
        metric = data.get("metric", "cosine")
        method = data.get("method", "auto")
        if not isinstance(metric, str) or not isinstance(method, str):
            return _json({"error": "metric/method must be strings"}, 400)
        key = ("-".join(sorted(video_names)) if video_names else "all", n_neighbors, min_dist,
               metric, method)
        cached = ctx.viz_cache.get(key)
        if cached is not None:
            return _json(cached)
        result = generate_visualization(
            ctx.index, ctx.metadata, video_names, method=method, n_neighbors=n_neighbors,
            min_dist=min_dist, metric=metric, device=ctx.engine.device,
        )
        if result is None:
            return _json({"error": "No embeddings found for visualization"}, 404)
        ctx.viz_cache.set(key, result)
        return _json(result)

    def ep_available(request):
        available = []
        for name in ctx.video_names():
            entry = ctx.registry.get(name) or {}
            emb = entry.get("embeddings_file")
            if not name.startswith("default") and emb and ctx.resolve_path(emb).exists():
                available.append({"name": name, "embeddings_file": emb,
                                  "video_path": entry.get("video_path", "")})
        return _json({"available_videos": available, "count": len(available)})

    def ep_models(request):
        models = [{"id": "original", "name": f"CLIP Original ({ctx.engine.model_name})",
                   "description": "Base CLIP model"}]
        for name in ctx.engine.available_models():
            if name != "original":
                models.append({"id": name, "name": f"CLIP Fine-tuned ({name})",
                               "description": "Fine-tuned CLIP checkpoint"})
        return _json(models)

    def ep_active_model(request):
        if request.method == "GET":
            # an index embedded with another model than the active one ranks worse
            index_models = {
                (ctx.registry.get(n) or {}).get("embedding_model", "original")
                for n in ctx.video_names()
            }
            payload = {"active_model": ctx.engine.active_model}
            if index_models and index_models - {ctx.engine.active_model}:
                payload["warning"] = (
                    f"index contains embeddings from models {sorted(index_models)}; "
                    f"queries use {ctx.engine.active_model!r}"
                )
            return _json(payload)
        data = request.get_json(silent=True) or {}
        if not isinstance(data, dict):
            return _json({"error": "request body must be a JSON object"}, 400)
        model_name = data.get("model")
        if not model_name or not isinstance(model_name, str):
            return _json({"error": "Model name is required"}, 400)
        if ctx.engine.set_active_model(model_name):
            return _json({"success": True, "active_model": ctx.engine.active_model})
        return _json({"success": False, "error": f"Failed to set model to {model_name}"}, 400)

    endpoints = {
        "health": ep_health,
        "index": ep_index,
        "frontend": ep_frontend,
        "stats": ep_stats,
        "videos": ep_videos,
        "video_events": ep_video_events,
        "search": ep_search,
        "upload": ep_upload,
        "upload_status": ep_upload_status,
        "frame": ep_frame,
        "video_file": ep_video_file,
        "transcribe": ep_transcribe,
        "umap": ep_umap,
        "available": ep_available,
        "models": ep_models,
        "active_model": ep_active_model,
    }

    @Request.application
    def app(request):
        if request.method == "OPTIONS":
            return _json({})
        adapter = url_map.bind_to_environ(request.environ)
        try:
            endpoint, values = adapter.match()
            return endpoints[endpoint](request, **values)
        except RequestRedirect as e:
            return e.get_response(request.environ)
        except NotFound:
            return _json({"error": "not found"}, 404)
        except HTTPException as e:
            return _json({"error": e.description}, e.code or 500)
        except Exception as e:  # blanket 500 with a structured body
            return _json({"error": str(e)}, 500)

    app.ctx = ctx
    app.url_map = url_map
    return app
