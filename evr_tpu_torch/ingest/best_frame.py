"""Best-frame selection: the CLIP argmax frame per caption.

Counterpart of ``evr_tpu/ingest/best_frame.py``: every frame embeds once,
every caption once, and the assignment is one similarity matrix.
"""

from __future__ import annotations

import json
import pathlib


def select_best_frames(engine, frames_dir, captions: list[str]) -> list[dict]:
    """For each caption, the best-matching frame in the folder:
    [{caption, frame, similarity}] aligned with ``captions``."""
    emb, names = engine.embed_folder(frames_dir, normalise=True)
    if not names:
        return []
    txt = engine.encode_texts(captions, normalise=True)
    sims = txt @ emb.T  # [C, N]
    best = sims.argmax(axis=1)
    return [
        {"caption": caption, "frame": names[int(b)], "similarity": float(sims[i, int(b)])}
        for i, (caption, b) in enumerate(zip(captions, best))
    ]


def build_frame_caption_mapping(
    engine, clips: dict[str, tuple[str, list[str]]], out_json=None
) -> dict:
    """clips: {clip_name: (frames_dir, captions)} → training-pair JSON
    ({frame_relpath: {caption, similarity}}) by best-frame selection."""
    mapping: dict = {}
    for clip_name, (frames_dir, captions) in clips.items():
        for row in select_best_frames(engine, frames_dir, captions):
            mapping[f"{clip_name}/{row['frame']}"] = {
                "caption": row["caption"], "similarity": row["similarity"]}
    if out_json:
        pathlib.Path(out_json).write_text(json.dumps(mapping, indent=2, ensure_ascii=False))
    return mapping
