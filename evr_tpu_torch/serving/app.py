"""HTTP API on a werkzeug WSGI app — the routes the port serves so far.

Counterpart of ``evr_tpu/serving/app.py``, with the same request validation
and response payloads for:

- ``GET /health``;
- ``GET /api/videos``;
- ``POST /api/search`` with ``search_type="text"`` and the ``text_clip`` or
  ``text_adaptive`` method (``"text"``, the default label, is text_adaptive).

Every other method and route answers 501 with a message naming it as not yet
ported (a search type or method the JAX package serves and the port does not
have yet, such as image search or upload, is a 501 too, not a 400).

Run: ``python -m evr_tpu_torch.serving --data-root data --port 5000``.
"""

from __future__ import annotations

import json

from werkzeug.exceptions import HTTPException
from werkzeug.routing import Map, Rule
from werkzeug.wrappers import Request, Response

from .context import ServingContext

PORTED_METHODS = ("text_clip", "text_adaptive")


def _json(payload, status: int = 200) -> Response:
    resp = Response(
        json.dumps(payload, ensure_ascii=False), status=status, mimetype="application/json"
    )
    resp.headers["Access-Control-Allow-Origin"] = "*"
    resp.headers["Access-Control-Allow-Headers"] = "Content-Type"
    resp.headers["Access-Control-Allow-Methods"] = "GET, POST, OPTIONS"
    return resp


def _not_ported(what: str) -> Response:
    return _json({"error": f"{what} is not yet ported to evr_tpu_torch"}, 501)


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
    if search_type != "text":
        return None, _not_ported(f"search_type {search_type!r}")
    if method not in PORTED_METHODS:
        return None, _not_ported(f"search_method {search_method!r}")
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


def create_app(ctx: ServingContext):
    url_map = Map(
        [
            Rule("/health", endpoint="health", methods=["GET"]),
            Rule("/api/videos", endpoint="videos", methods=["GET"]),
            Rule("/api/search", endpoint="search", methods=["POST"]),
        ]
    )

    def ep_health(request):
        return _json({"status": "ok"})

    def ep_videos(request):
        ctx.prune_missing()
        videos = []
        for idx, name in enumerate(ctx.video_names(), 1):
            summary = ctx.video_summary(idx, name)
            if summary is not None:
                videos.append(summary)
        return _json(videos)

    def ep_search(request):
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

        qe = ctx.query_engine
        results: list[dict] = []
        top_k = req["top_k"]
        if req["query"]:
            if req["method"] == "text_clip":
                results = qe.query_text_clip(
                    req["query"], top_k, video_name, mmr_lambda=req["mmr_lambda"],
                    negative_query=req["negative_query"],
                    negative_weight=req["negative_weight"],
                )
            else:
                results = qe.query_text_adaptive(
                    req["query"], req["adaptive_threshold"], top_k, video_name,
                    mmr_lambda=req["mmr_lambda"],
                )
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
        # the default label "text" ranks by fused confidence, as the JAX app does
        if req["search_method"] in PORTED_METHODS or req["enable_clip_similarity"]:
            results.sort(key=lambda x: x.get("clip_similarity", 0), reverse=True)
        else:
            results.sort(key=lambda x: x.get("confidence", 0), reverse=True)
        payload = {"events": results[:top_k]}
        ctx.search_cache.set(cache_key, payload)
        return _json(payload)

    endpoints = {"health": ep_health, "videos": ep_videos, "search": ep_search}

    @Request.application
    def app(request):
        if request.method == "OPTIONS":
            return _json({})
        adapter = url_map.bind_to_environ(request.environ)
        try:
            endpoint, values = adapter.match(method=request.method)
        except HTTPException:  # no route or no method here: not ported yet
            return _not_ported(f"{request.method} {request.path}")
        try:
            return endpoints[endpoint](request, **values)
        except Exception as e:  # blanket 500 with a structured body
            return _json({"error": str(e)}, 500)

    app.ctx = ctx
    app.url_map = url_map
    return app
