"""Zero-shot object annotation over the serving CLIP towers (PyTorch).

Counterpart of ``evr_tpu/ingest/zeroshot.py``. The reference fills each frame
record's ``object_detections`` with YOLOv8; this module fills the same schema
with the towers the engine already serves:

* a fixed multi-scale grid of region proposals per frame (the full frame and
  overlapping half- and third-size windows);
* every crop is staged to the model's input size on the host
  (``ops.preprocess.stage_array_fast``) and encoded by the engine's vision
  tower (``encode_staged_images``: batches of ``engine.batch_size``, the tail
  padded; K1/K2 on bf16 weights and K3a/K3b on int8 weights on the card,
  split over the slots of a mesh engine);
* the features in fp32, normalised with ``max(norm, 1e-6)``, times the
  ``[C + B, D]`` prompt-ensembled label classifier
  (``evaluation.zeroshot.build_zeroshot_classifier`` over the text tower,
  and the background prompts): one ``[R·N, D] @ [D, C + B]`` product;
* per-region argmax with a background-prompt rejector, then per-class NMS
  over the grid, emit detections in the reference schema (label,
  bounding_box [x, y, w, h] normalised, confidence).

The default vocabulary is COCO-80, the label set of the reference's YOLOv8,
so object searches behave as they do on the reference's metadata. The host
arithmetic (the region edges in float32, NMS's order, the class walk) is a
copy of the JAX package's: each of them decides a result.
"""

from __future__ import annotations

import pathlib

import numpy as np

# The COCO-80 vocabulary (ultralytics YOLOv8's ``model.names``): the labels of
# the reference's metadata stay searchable after a zero-egress ingest
COCO_CLASSES: tuple[str, ...] = (
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella",
    "handbag", "tie", "suitcase", "frisbee", "skis", "snowboard",
    "sports ball", "kite", "baseball bat", "baseball glove", "skateboard",
    "surfboard", "tennis racket", "bottle", "wine glass", "cup", "fork",
    "knife", "spoon", "bowl", "banana", "apple", "sandwich", "orange",
    "broccoli", "carrot", "hot dog", "pizza", "donut", "cake", "chair",
    "couch", "potted plant", "bed", "dining table", "toilet", "tv",
    "laptop", "mouse", "remote", "keyboard", "cell phone", "microwave",
    "oven", "toaster", "sink", "refrigerator", "book", "clock", "vase",
    "scissors", "teddy bear", "hair drier", "toothbrush",
)

# Rejector prompts: a region yields a detection only when its best object
# class beats every one of these (+ margin). Plain prompts, not
# template-ensembled: they describe the absence of a nameable object.
BACKGROUND_PROMPTS: tuple[str, ...] = (
    "a photo of the background.",
    "a blurry photo with nothing in it.",
    "a photo of an empty scene.",
    "a plain texture.",
    "a photo of a wall.",
)


def make_region_grid(
    scales: tuple[tuple[float, int], ...] = ((1.0, 1), (0.5, 3), (1.0 / 3.0, 3)),
) -> np.ndarray:
    """Fixed proposal grid: for each ``(window_size, positions_per_axis)``,
    windows of that normalised size at ``p×p`` evenly spaced positions
    (overlapping when p > 1/size). Returns [R, 4] float32 ``[x, y, w, h]``.
    Default: 1 full frame + 9 half-size + 9 third-size = 19 regions."""
    boxes = []
    for size, p in scales:
        if p == 1:
            offsets = [max(0.0, (1.0 - size) / 2.0)]
        else:
            span = 1.0 - size
            offsets = [span * i / (p - 1) for i in range(p)]
        for y in offsets:
            for x in offsets:
                boxes.append((x, y, size, size))
    return np.asarray(boxes, np.float32)


def _iou_xywh(a: np.ndarray, b: np.ndarray) -> float:
    ax1, ay1, ax2, ay2 = a[0], a[1], a[0] + a[2], a[1] + a[3]
    bx1, by1, bx2, by2 = b[0], b[1], b[0] + b[2], b[1] + b[3]
    iw = max(0.0, min(ax2, bx2) - max(ax1, bx1))
    ih = max(0.0, min(ay2, by2) - max(ay1, by1))
    inter = iw * ih
    union = a[2] * a[3] + b[2] * b[3] - inter
    return float(inter / union) if union > 0 else 0.0


def nms_xywh(boxes: np.ndarray, scores: np.ndarray, iou_threshold: float) -> list[int]:
    """Greedy NMS over [N, 4] normalised xywh boxes; returns kept indices
    in descending score order."""
    order = list(np.argsort(-np.asarray(scores)))
    keep: list[int] = []
    while order:
        i = order.pop(0)
        keep.append(i)
        order = [j for j in order if _iou_xywh(boxes[i], boxes[j]) < iou_threshold]
    return keep


class ZeroShotObjectAnnotator:
    """``Annotator``-protocol object detector over the serving CLIP towers.

    ``engine``: an ``EmbeddingEngine`` (or anything with ``encode_texts``,
    ``encode_staged_images``, ``cfg.vision.image_size``); the annotator runs
    where the engine runs and raises where it raises. Implements the
    per-frame ``__call__`` and the batched ``annotate_batch(paths)`` that
    ``annotate_folder`` prefers (every frame's crops through the tower in
    engine-sized batches).

    Thresholds (for real CLIP ViT-B/32 cosine ranges):

    * ``sim_threshold``: least cosine similarity of the winning class;
    * ``bg_margin``: the winning class must beat the best background prompt
      by this much;
    * the ``confidence`` reported is the softmax probability (temperature =
      CLIP's logit scale 100) of the winning class over [classes + bg].
    """

    def __init__(
        self,
        engine,
        classnames: tuple[str, ...] | list[str] = COCO_CLASSES,
        templates=None,
        background_prompts: tuple[str, ...] = BACKGROUND_PROMPTS,
        scales: tuple[tuple[float, int], ...] = ((1.0, 1), (0.5, 3), (1.0 / 3.0, 3)),
        sim_threshold: float = 0.22,
        bg_margin: float = 0.0,
        temperature: float = 100.0,
        nms_iou: float = 0.5,
        max_detections: int = 12,
    ):
        self.engine = engine
        self.classnames = list(classnames)
        self.templates = templates
        self.background_prompts = list(background_prompts)
        self.regions = make_region_grid(scales)
        self.sim_threshold = float(sim_threshold)
        self.bg_margin = float(bg_margin)
        self.temperature = float(temperature)
        self.nms_iou = float(nms_iou)
        self.max_detections = int(max_detections)
        self._W = None  # [C + B, D], built at first use (a text pass)

    # -- classifier -------------------------------------------------------
    def _classifier(self) -> np.ndarray:
        """[C + B, D] unit rows: the prompt-ensembled classes, then the
        background prompts; built once (two text encodes)."""
        if self._W is None:
            from evr_tpu_torch.evaluation.zeroshot import (
                DEFAULT_TEMPLATES,
                build_zeroshot_classifier,
            )

            w_obj = build_zeroshot_classifier(
                self.engine.encode_texts,
                self.classnames,
                templates=self.templates or DEFAULT_TEMPLATES,
            ).T  # [C, D]
            w_bg = np.asarray(
                self.engine.encode_texts(self.background_prompts), np.float32
            )
            w_bg = w_bg / (np.linalg.norm(w_bg, axis=-1, keepdims=True) + 1e-12)
            self._W = np.concatenate([w_obj, w_bg], axis=0).astype(np.float32)
        return self._W

    # -- crops ------------------------------------------------------------
    def _stage_crops(self, rgb: np.ndarray) -> np.ndarray:
        """uint8 RGB frame → [R, S, S, 3] staged crops (one per region)."""
        from evr_tpu_torch.ops.preprocess import stage_array_fast

        size = self.engine.cfg.vision.image_size
        h, w = rgb.shape[:2]
        crops = []
        for x, y, bw, bh in self.regions:
            x0, y0 = int(round(x * w)), int(round(y * h))
            x1 = min(w, max(x0 + 2, int(round((x + bw) * w))))
            y1 = min(h, max(y0 + 2, int(round((y + bh) * h))))
            crops.append(stage_array_fast(rgb[y0:y1, x0:x1], size))
        return np.stack(crops)

    def _score_crops(self, staged: np.ndarray) -> np.ndarray:
        """[M, S, S, 3] uint8 → [M, C + B] cosine similarities: the vision
        tower in the engine's batches (tail padded), fp32 features normalised
        with ``max(norm, 1e-6)``, one product with the classifier."""
        w = self._classifier()
        if not len(staged):
            return np.zeros((0, len(w)), np.float32)
        f = np.asarray(self.engine.encode_staged_images(staged, normalise=False), np.float32)
        f = f / np.maximum(np.linalg.norm(f, axis=-1, keepdims=True), 1e-6)
        return f @ w.T

    # -- detection --------------------------------------------------------
    def _detect(self, sims: np.ndarray) -> list[dict]:
        """[R, C+B] region similarities → reference-schema detections."""
        n_cls = len(self.classnames)
        obj, bg = sims[:, :n_cls], sims[:, n_cls:]
        probs = _softmax(sims * self.temperature, axis=-1)
        best = obj.argmax(axis=-1)
        rows = np.arange(len(sims))
        best_sim = obj[rows, best]
        bg_best = bg.max(axis=-1) if bg.shape[1] else np.full(len(sims), -np.inf)
        accept = (best_sim >= self.sim_threshold) & (
            best_sim > bg_best + self.bg_margin
        )
        cand_idx = np.nonzero(accept)[0]
        detections: list[dict] = []
        for cls in set(best[cand_idx].tolist()):
            idx = cand_idx[best[cand_idx] == cls]
            keep = nms_xywh(
                self.regions[idx], probs[idx, cls], self.nms_iou
            )
            for k in keep:
                r = idx[k]
                detections.append(
                    {
                        "label": self.classnames[cls],
                        "bounding_box": [float(v) for v in self.regions[r]],
                        "confidence": float(probs[r, cls]),
                    }
                )
        detections.sort(key=lambda d: -d["confidence"])
        return detections[: self.max_detections]

    # -- Annotator protocol -------------------------------------------------
    def stage_frames(self, paths) -> tuple[list, np.ndarray]:
        """Each frame's ``(lo, hi)`` span of the stacked crops (None for a
        frame that does not decode) and the crops [R·N, S, S, 3] uint8."""
        import cv2

        staged_all, spans = [], []
        for p in paths:
            img = cv2.imread(str(p), cv2.IMREAD_COLOR)
            if img is None:
                spans.append(None)
                continue
            crops = self._stage_crops(np.ascontiguousarray(img[:, :, ::-1]))
            spans.append((len(staged_all), len(staged_all) + len(crops)))
            staged_all.extend(crops)
        size = self.engine.cfg.vision.image_size
        stacked = np.stack(staged_all) if staged_all else np.zeros((0, size, size, 3), np.uint8)
        return spans, stacked

    def annotate_batch(self, paths) -> list[dict]:
        """Annotate many frames: every frame's crops through the tower in
        engine-sized batches."""
        spans, staged = self.stage_frames(paths)
        sims = self._score_crops(staged) if len(staged) else np.zeros((0, 1), np.float32)
        results = []
        for span in spans:
            if span is None:
                results.append({"text_detections": [], "object_detections": []})
            else:
                results.append(
                    {
                        "text_detections": [],
                        "object_detections": self._detect(sims[span[0] : span[1]]),
                    }
                )
        return results

    def __call__(self, image_path) -> dict:
        return self.annotate_batch([pathlib.Path(image_path)])[0]


def _softmax(x: np.ndarray, axis: int = -1) -> np.ndarray:
    x = x - x.max(axis=axis, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=axis, keepdims=True)
