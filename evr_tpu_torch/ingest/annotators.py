"""OCR and object-detection annotator adapters.

Counterpart of ``evr_tpu/ingest/annotators.py``: EasyOCR and Ultralytics
YOLO stay third-party host-side models; these adapters wrap them into the
``Annotator`` protocol with normalised bounding boxes and raise
``ImportError`` when their packages are absent. ``CompositeAnnotator``
merges several annotators' outputs into one detection dict;
``build_annotator`` makes the frame annotator the ingest and serving CLIs
run.
"""

from __future__ import annotations


def _norm_box(x, y, w, h, width, height):
    return [x / width, y / height, w / width, h / height]


class EasyOCRAnnotator:
    """EasyOCR text detections → the reference schema."""

    def __init__(self, languages=("vi", "en"), gpu: bool = False):
        try:
            import easyocr
        except ImportError as e:
            raise ImportError(
                "easyocr is not installed; OCR annotation is an optional host-side plugin"
            ) from e
        self.reader = easyocr.Reader(list(languages), gpu=gpu)

    def __call__(self, image_path) -> dict:
        from PIL import Image

        with Image.open(image_path) as img:
            width, height = img.size
        detections = []
        for bbox, text, conf in self.reader.readtext(str(image_path)):
            xs = [p[0] for p in bbox]
            ys = [p[1] for p in bbox]
            x, y = min(xs), min(ys)
            detections.append({
                "label": text,
                "bounding_box": _norm_box(x, y, max(xs) - x, max(ys) - y, width, height),
                "confidence": float(conf),
            })
        return {"text_detections": detections, "object_detections": []}


class YOLOAnnotator:
    """Ultralytics YOLO object detections → the reference schema."""

    def __init__(self, weights: str = "yolov8x.pt", conf: float = 0.25):
        try:
            from ultralytics import YOLO
        except ImportError as e:
            raise ImportError(
                "ultralytics is not installed; object annotation is an optional host-side plugin"
            ) from e
        self.model = YOLO(weights)
        self.conf = conf

    def __call__(self, image_path) -> dict:
        results = self.model(str(image_path), conf=self.conf, verbose=False)
        detections = []
        for result in results:
            names = result.names
            h, w = result.orig_shape
            for box in result.boxes:
                x1, y1, x2, y2 = box.xyxy[0].tolist()
                detections.append({
                    "label": names[int(box.cls[0])],
                    "bounding_box": _norm_box(x1, y1, x2 - x1, y2 - y1, w, h),
                    "confidence": float(box.conf[0]),
                })
        return {"text_detections": [], "object_detections": detections}


class CompositeAnnotator:
    """Several annotators' outputs merged (text lists and object lists
    concatenated in order)."""

    def __init__(self, *annotators):
        self.annotators = annotators

    def __call__(self, image_path) -> dict:
        out = {"text_detections": [], "object_detections": []}
        for ann in self.annotators:
            result = ann(image_path)
            out["text_detections"] += list(result.get("text_detections", []))
            out["object_detections"] += list(result.get("object_detections", []))
        return out

    def annotate_batch(self, paths) -> list[dict]:
        """The folder-batched protocol ``annotate_folder`` prefers: children
        with ``annotate_batch`` keep their batching, the rest run per frame."""
        merged = [{"text_detections": [], "object_detections": []} for _ in paths]
        for ann in self.annotators:
            results = ann.annotate_batch(paths) if hasattr(ann, "annotate_batch") else [ann(p) for p in paths]
            for out, result in zip(merged, results):
                out["text_detections"] += list(result.get("text_detections", []))
                out["object_detections"] += list(result.get("object_detections", []))
        return merged


def build_annotator(engine, zeroshot_objects: bool = False, local_ocr: str = "auto", device=None):
    """The CLIs' frame annotator, as the JAX CLIs build it: the zero-shot
    object annotator over ``engine`` when ``zeroshot_objects``, then the
    local OCR annotator on ``device`` when ``local_ocr`` is "on", or "auto"
    and its checkpoint exists; merged by ``CompositeAnnotator`` when there
    are two, None when there is none."""
    annotators = []
    if zeroshot_objects:
        from .zeroshot import ZeroShotObjectAnnotator

        annotators.append(ZeroShotObjectAnnotator(engine))
    if local_ocr != "off":
        from .ocr import DEFAULT_CHECKPOINT, LocalOCRAnnotator

        if local_ocr == "on" or DEFAULT_CHECKPOINT.exists():
            annotators.append(LocalOCRAnnotator(device=device))
    if not annotators:
        return None
    return annotators[0] if len(annotators) == 1 else CompositeAnnotator(*annotators)
