"""Embedding-space 2-D visualization (counterpart of the JAX package's
``viz/projection.py``).

Reference counterpart: ``VisualizationService`` (`Backend/services/
visualization_service.py`): concatenates per-video embedding matrices, runs
``umap.UMAP(n_neighbors, min_dist, metric='cosine', random_state=42)``, and
returns coordinates + simplified per-point metadata with a 24 h cache.

``method='umap'`` (and the default ``'auto'``; ``'umap_jax'`` is the JAX
package's name for it and stays accepted) runs the real UMAP algorithm on the
card (``viz/umap.py`` — fuzzy simplicial set + negative-sampling SGD layout,
honouring n_neighbors/min_dist semantics); ``'umap-learn'`` opts into the
host numba package when installed; ``'tsne_jax'`` runs ``viz/tsne.py`` on the
card, ``'tsne'`` sklearn's; any other method is PCA by an SVD on the host
(numpy, signs as sklearn fixes them, so no sklearn is needed). The response dict
shape is identical to the reference's (`visualization_service.py:208-221`),
so the React VisualizationPanel renders it unchanged;
``dimensionality_reduction.method`` reports what actually ran.
"""

from __future__ import annotations

import os

import numpy as np


def pca(emb: np.ndarray, n_components: int = 2) -> np.ndarray:
    """Principal-component projection of (N, D) rows by a full SVD of the
    centred rows, each component's sign set so that its largest-magnitude
    loading is positive (sklearn's ``svd_flip(u_based_decision=False)``);
    padded with zero columns past min(N, D)."""
    x = np.asarray(emb, np.float64)
    n_comp = min(n_components, x.shape[0], x.shape[1])
    xc = x - x.mean(axis=0, keepdims=True)
    _, _, vt = np.linalg.svd(xc, full_matrices=False)
    vt = vt[:n_comp]
    signs = np.sign(vt[np.arange(n_comp), np.argmax(np.abs(vt), axis=1)])
    coords = (xc @ (vt * signs[:, None]).T).astype(np.float32)
    if coords.shape[1] < n_components:
        coords = np.pad(coords, ((0, 0), (0, n_components - coords.shape[1])))
    return coords


def project_embeddings(
    embeddings: np.ndarray,
    method: str = "auto",
    n_neighbors: int = 15,
    min_dist: float = 0.1,
    n_components: int = 2,
    metric: str = "cosine",
    random_state: int = 42,
    device=None,
) -> tuple[np.ndarray, str]:
    """Reduce (N, D) → (N, n_components). Returns (coords, method_used).
    ``device``: where UMAP and t-SNE run (the card when None)."""
    emb = np.asarray(embeddings, np.float32)
    if metric == "cosine":
        norms = np.linalg.norm(emb, axis=1, keepdims=True)
        emb = emb / np.maximum(norms, 1e-12)

    if method == "umap-learn":
        # explicit opt-in to the host numba implementation when installed
        import umap  # pragma: no cover - optional dependency

        reducer = umap.UMAP(
            n_neighbors=n_neighbors,
            min_dist=min_dist,
            n_components=n_components,
            metric=metric,
            random_state=random_state,
        )
        return np.asarray(reducer.fit_transform(emb)), "umap-learn"
    if method in ("auto", "umap", "umap_jax"):
        # the real UMAP algorithm on the card (viz/umap.py) — n_neighbors /
        # min_dist carry their true semantics
        from .umap import umap

        coords = umap(
            emb,
            n_components=n_components,
            n_neighbors=n_neighbors,
            min_dist=min_dist,
            metric=metric,
            random_state=random_state,
            device=device,
        )
        return coords, "umap"
    if method == "tsne_jax":
        from .tsne import tsne

        coords = tsne(
            emb,
            n_components=n_components,
            random_state=random_state,
            metric="euclidean",  # emb already normalised above for cosine
            device=device,
        )
        return coords, "tsne_jax"
    if method == "tsne":
        from sklearn.manifold import TSNE

        perplexity = min(30.0, max(5.0, (len(emb) - 1) / 3))
        coords = TSNE(
            n_components=n_components,
            perplexity=perplexity,
            random_state=random_state,
            init="pca",
        ).fit_transform(emb)
        return np.asarray(coords), "tsne"

    return pca(emb, n_components), "pca"


def render_scatter(result: dict, out_path, point_size: float = 8.0) -> str | None:
    """Optional matplotlib PNG render of a visualization payload
    (`visualization_service.py:237-299` parity)."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:  # pragma: no cover
        return None
    coords = np.asarray(result["coordinates"])
    labels = result["video_labels"]
    videos = result["videos"]
    color_of = {v: i for i, v in enumerate(videos)}
    colors = [color_of[v] for v in labels]
    fig, ax = plt.subplots(figsize=(8, 6))
    scatter = ax.scatter(
        coords[:, 0], coords[:, 1], c=colors, cmap="tab10", s=point_size, alpha=0.7
    )
    handles = [
        plt.Line2D(
            [], [], marker="o", linestyle="", label=v,
            color=scatter.cmap(scatter.norm(color_of[v])),
        )
        for v in videos
    ]
    ax.legend(handles=handles, fontsize=7)
    method = result.get("dimensionality_reduction", {}).get("method", "?")
    ax.set_title(f"frame embeddings ({method})")
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return str(out_path)


def generate_visualization(
    index,
    metadata_store,
    video_names: list[str] | None = None,
    method: str = "auto",
    n_neighbors: int = 15,
    min_dist: float = 0.1,
    n_components: int = 2,
    metric: str = "cosine",
    max_points: int | None = 20_000,
    device=None,
) -> dict | None:
    """Build the full visualization payload (reference response-shape
    parity: coordinates, video_labels, frame_indices, metadata, videos,
    dimensionality_reduction).

    ``max_points`` bounds the scatter for serving: past it the frames are
    deterministically stride-downsampled (every video keeps proportional
    representation since rows are video-ordered) and the response records
    ``downsampled_from`` so the frontend can surface it. 20k points is
    past the interactive envelope of the scatter itself; None disables the
    cap. ``device``: where the projection runs (the card when None)."""
    videos = video_names or index.videos
    mats, video_labels, frame_indices, metas = [], [], [], []
    for name in videos:
        if name not in index.videos:
            continue
        emb = index.get_embeddings(name, normalised=False)
        frames = metadata_store.frames(name)
        n = min(len(emb), len(frames)) if frames else len(emb)
        mats.append(emb[:n])
        for i in range(n):
            video_labels.append(name)
            if frames:
                fr = frames[i]
                frame_indices.append(fr.frameidx)
                raw = fr.raw
            else:
                frame_indices.append(i)
                raw = {}
            filepath = raw.get("filepath", "")
            info = {
                "video_name": name,
                "frameidx": frame_indices[-1],
                "filepath": (
                    f"/api/frame/{os.path.basename(filepath)}" if filepath else ""
                ),
                "original_filepath": filepath,
                "frame_id": len(metas),
                # always present (empty when undetected): the frontend reads
                # point.metadata.text/.object unconditionally
                # (VisualizationPanel.tsx:688-696)
                "text": "",
                "object": "",
            }
            text_dets = (raw.get("text_detections") or {}).get("detections") or []
            if text_dets:
                best = max(text_dets, key=lambda d: d.get("confidence", 0))
                info["text"] = best.get("label", "")
                info["text_confidence"] = best.get("confidence", 0)
            obj_dets = (raw.get("object_detections") or {}).get("detections") or []
            if obj_dets:
                best = max(obj_dets, key=lambda d: d.get("confidence", 0))
                info["object"] = best.get("label", "")
                info["object_confidence"] = best.get("confidence", 0)
            metas.append(info)

    if not mats:
        return None
    embeddings = np.concatenate(mats, axis=0)
    downsampled_from = None
    if max_points is not None and len(embeddings) > max_points:
        downsampled_from = len(embeddings)
        keep = np.linspace(0, len(embeddings) - 1, max_points).astype(int)
        embeddings = embeddings[keep]
        video_labels = [video_labels[i] for i in keep]
        frame_indices = [frame_indices[i] for i in keep]
        metas = [metas[i] for i in keep]
        for new_id, m in enumerate(metas):
            m["frame_id"] = new_id
    coords, used = project_embeddings(
        embeddings,
        method=method,
        n_neighbors=n_neighbors,
        min_dist=min_dist,
        n_components=n_components,
        metric=metric,
        device=device,
    )
    return {
        "coordinates": coords.tolist(),
        "video_labels": video_labels,
        "frame_indices": frame_indices,
        "metadata": metas,
        "videos": sorted(set(video_labels)),
        "dimensionality_reduction": {
            "method": used,
            "parameters": {
                "n_neighbors": n_neighbors,
                "min_dist": min_dist,
                "n_components": n_components,
                "metric": metric,
            },
            **(
                {"downsampled_from": downsampled_from}
                if downsampled_from else {}
            ),
        },
    }
