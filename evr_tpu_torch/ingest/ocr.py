"""Zero-egress OCR: the text half of the frame annotator (PyTorch).

Counterpart of ``evr_tpu/ingest/ocr.py``. The reference fills each frame
record's ``text_detections`` with EasyOCR; this module does it with a
two-stage pipeline that needs no download:

* **Detection** (host, OpenCV): gradient magnitude, Otsu threshold, a wide
  horizontal close (the characters of a line fuse into one component), then
  connected components filtered by height, aspect and fill. Polarity-free.
* **Recognition** (device): a small CRNN-style convolution tower over fixed
  [32, 256] grayscale line crops, class logits for each of 64 width
  positions, greedy CTC decode on the host. ``F.conv2d`` / ``F.conv1d`` in
  fp32 with TF32 off, the JAX recogniser's arithmetic: "SAME" padding by
  XLA's rule (stride 2 pads only after), the tanh GELU of ``jax.nn.gelu``,
  and the height axis collapsed into the features as ``h * 128 + c`` (the
  NHWC order the carried weights read).
* **Training** (device): CTC on synthetic renders of a mixed lexicon drawn
  with the DejaVu fonts, with scale, pad, polarity and noise jitter. The
  dataset is rendered once on the host and moved to the device once; the
  optimiser is optax's ``chain(clip_by_global_norm(1.0), adamw(warmup
  cosine))`` written out (``training.variants.AdamW``), and the minibatch
  indices are drawn as the JAX trainer draws them, so a seed sees its
  batches.

A trained checkpoint is kept at ``ingest/assets/ocr_ctc.npz`` (the arrays the
JAX package ships, byte for byte), so an ingest recognises text with no
set-up; retrain with ``python -m evr_tpu_torch.tools.train_ocr``. The host
parts (labels, renders, staging, detection, decoding) are copies of the JAX
package's and give its arrays bit for bit.
"""

from __future__ import annotations

import math
import pathlib

import numpy as np
import torch
import torch.nn.functional as F

from evr_tpu_torch.utils.device import full_fp32, resolve_device

# class 0 is the CTC blank; class i+1 emits CHARSET[i]
CHARSET = (
    " abcdefghijklmnopqrstuvwxyz0123456789-.:!?'\""
    # Vietnamese lowercase (the reference OCR language)
    "àáảãạăằắẳẵặâầấẩẫậèéẻẽẹêềếểễệìíỉĩịòóỏõọôồốổỗộơờớởỡợ"
    "ùúủũụưừứửữựỳýỷỹỵđ"
)
BLANK_ID = 0

IMG_H, IMG_W = 32, 256
MAX_LABEL = 24

_ASSETS_DIR = pathlib.Path(__file__).parent / "assets"
DEFAULT_CHECKPOINT = _ASSETS_DIR / "ocr_ctc.npz"

_FONT_DIR = pathlib.Path("/usr/share/fonts/truetype/dejavu")
FONT_PATHS = tuple(
    str(_FONT_DIR / name)
    for name in (
        "DejaVuSans.ttf",
        "DejaVuSans-Bold.ttf",
        "DejaVuSerif.ttf",
        "DejaVuSansMono.ttf",
    )
    if (_FONT_DIR / name).exists()
)

# a compact seed lexicon: words the fixture corpus and its queries use (tags,
# violence-domain vocabulary, common English/Vietnamese words); random strings
# in the training mix keep the model character-general
LEXICON_WORDS = (
    "the and for with news live breaking video camera scene street night "
    "day man woman people crowd police fire fight fighting violence gun "
    "knife attack danger warning alert stop exit open closed sale free "
    "hello world test frame event action match goal score time date "
    "subscribe channel follow like share comment city road car bus "
    "tin tức an ninh cảnh sát bạo lực đánh nhau nguy hiểm cảnh báo "
    "dừng lại lối ra mở cửa đóng cửa miễn phí xin chào thế giới "
    "người đàn ông phụ nữ đám đông đường phố thành phố buổi tối"
).split()


def encode_label(text: str) -> list[int]:
    """text → CTC class ids (chars outside CHARSET are dropped)."""
    lut = {c: i + 1 for i, c in enumerate(CHARSET)}
    return [lut[c] for c in text.lower() if c in lut]


def decode_ids(ids) -> str:
    return "".join(CHARSET[i - 1] for i in ids if 0 < i <= len(CHARSET))


# -- synthetic render training data ------------------------------------------

def render_line(
    text: str,
    rng: np.random.Generator,
    font_path: str | None = None,
    augment: bool = True,
) -> np.ndarray:
    """Render one text line to a [IMG_H, IMG_W] float32 image in [0, 1]
    (text bright on dark; polarity augmentation flips it)."""
    from PIL import Image, ImageDraw, ImageFont

    font_path = font_path or FONT_PATHS[int(rng.integers(len(FONT_PATHS)))]
    size = int(rng.integers(18, 30)) if augment else 24
    font = ImageFont.truetype(font_path, size)
    x0, y0, x1, y1 = font.getbbox(text)
    w = max(1, x1 - x0)
    h = max(1, y1 - y0)
    pad = int(rng.integers(2, 8)) if augment else 4
    img = Image.new("L", (w + 2 * pad, h + 2 * pad), 0)
    ImageDraw.Draw(img).text((pad - x0, pad - y0), text, fill=255, font=font)
    arr = np.asarray(img, np.float32) / 255.0
    return stage_crop(arr, rng if augment else None)


def stage_crop(
    gray01: np.ndarray, rng: np.random.Generator | None = None
) -> np.ndarray:
    """Any-size [h, w] float line crop → the recogniser's fixed [IMG_H,
    IMG_W] input: height-normalised proportional resize, left-aligned, zero
    right-pad (or cut if over-wide). Optional augmentation: polarity flip,
    contrast jitter, additive noise."""
    import cv2

    h, w = gray01.shape
    scale = IMG_H / h
    new_w = max(1, min(IMG_W, int(round(w * scale))))
    out = cv2.resize(
        gray01.astype(np.float32), (new_w, IMG_H),
        interpolation=cv2.INTER_AREA if scale < 1 else cv2.INTER_LINEAR,
    )
    canvas = np.zeros((IMG_H, IMG_W), np.float32)
    canvas[:, :new_w] = out[:, :IMG_W]
    if rng is not None:
        if rng.random() < 0.5:
            canvas = canvas.max() - canvas  # polarity flip
        lo, hi = rng.uniform(0.0, 0.15), rng.uniform(0.75, 1.0)
        canvas = lo + canvas * (hi - lo)
        canvas = canvas + rng.normal(0, rng.uniform(0.01, 0.05), canvas.shape)
        canvas = np.clip(canvas, 0.0, 1.0).astype(np.float32)
    # per-crop standardisation: polarity and contrast are augmentation's,
    # brightness and scale are handled here
    canvas = canvas - canvas.mean()
    canvas = canvas / max(canvas.std(), 1e-5)
    return canvas.astype(np.float32)


def sample_text(rng: np.random.Generator) -> str:
    """Training-text sampler: words, short phrases, and random strings."""
    kind = rng.random()
    if kind < 0.45:  # lexicon word(s)
        n = int(rng.integers(1, 4))
        words = [
            LEXICON_WORDS[int(rng.integers(len(LEXICON_WORDS)))]
            for _ in range(n)
        ]
        text = " ".join(words)
    elif kind < 0.75:  # random letter string (character generality)
        n = int(rng.integers(2, 12))
        letters = CHARSET[1:37]  # a-z0-9
        text = "".join(letters[int(rng.integers(len(letters)))] for _ in range(n))
    else:  # random full-charset string incl. accents
        n = int(rng.integers(2, 10))
        text = "".join(
            CHARSET[int(rng.integers(1, len(CHARSET)))] for _ in range(n)
        )
    text = text.strip()[: MAX_LABEL]
    return text if text else "a"


def make_dataset(
    n: int, seed: int = 0, render=None
) -> tuple[np.ndarray, np.ndarray, np.ndarray, list[str]]:
    """Pre-render ``n`` (image, label) pairs: images [n, IMG_H, IMG_W, 1],
    labels [n, MAX_LABEL] (0-padded), label_paddings [n, MAX_LABEL].
    ``render(text, rng)`` draws one staged line, ``render_line`` (the DejaVu
    fonts) when None."""
    render = render or render_line
    rng = np.random.default_rng(seed)
    imgs = np.zeros((n, IMG_H, IMG_W, 1), np.float32)
    labels = np.zeros((n, MAX_LABEL), np.int32)
    pads = np.ones((n, MAX_LABEL), np.float32)
    texts = []
    for i in range(n):
        text = sample_text(rng)
        ids = encode_label(text)[:MAX_LABEL]
        if not ids:
            text, ids = "a", encode_label("a")
        imgs[i, :, :, 0] = render(text, rng)
        labels[i, : len(ids)] = ids
        pads[i, : len(ids)] = 0.0
        texts.append(text)
    return imgs, labels, pads, texts


# -- recogniser model ---------------------------------------------------------

N_CLASSES = len(CHARSET) + 1
# conv tower: (out_ch, stride_h, stride_w); H 32→2, W 256→64
_CONV_PLAN = ((32, 2, 2), (64, 2, 2), (96, 2, 1), (128, 2, 1))
_SEQ_LEN = IMG_W // 4  # 64 width positions after the two stride-2-W convs
_SEQ_WIDTH = 256  # per-position feature width (2 * 128 collapsed height)
_MIX_K = 5


def init_ocr_params(generator: torch.Generator | None = None) -> dict:
    """He-normal convolution kernels (HWIO, as the JAX package stores them),
    zero biases; drawn on the CPU from ``generator``."""
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    params: dict = {}
    c_in = 1
    for i, (c_out, _, _) in enumerate(_CONV_PLAN):
        fan = 3 * 3 * c_in
        params[f"conv{i}_w"] = torch.randn((3, 3, c_in, c_out), generator=g) * (2.0 / fan) ** 0.5
        params[f"conv{i}_b"] = torch.zeros((c_out,))
        c_in = c_out
    # width-context mixing conv (kernel 5 over the sequence axis)
    params["mix_w"] = (
        torch.randn((_MIX_K, _SEQ_WIDTH, _SEQ_WIDTH), generator=g)
        * (2.0 / (_MIX_K * _SEQ_WIDTH)) ** 0.5
    )
    params["mix_b"] = torch.zeros((_SEQ_WIDTH,))
    params["out_w"] = torch.randn((_SEQ_WIDTH, N_CLASSES), generator=g) * (1.0 / _SEQ_WIDTH) ** 0.5
    params["out_b"] = torch.zeros((N_CLASSES,))
    return params


def params_to(params: dict, device) -> dict:
    """Every leaf copied to an fp32 tensor on ``device`` (numpy arrays or
    tensors; training updates the copies in place)."""
    return {k: (v.detach() if torch.is_tensor(v) else torch.from_numpy(np.array(v, np.float32))).to(
                device=device, dtype=torch.float32, copy=True)
            for k, v in params.items()}


def same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """XLA's "SAME" padding of one axis: ``ceil(n / s)`` outputs, the total
    pad ``max((ceil(n / s) - 1) * s + k - n, 0)``, the smaller half before."""
    total = max((math.ceil(n / s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def ocr_logits(params: dict, images: torch.Tensor) -> torch.Tensor:
    """[B, 32, 256, 1] float → [B, SEQ_LEN, N_CLASSES] fp32 logits, on the
    device of ``images`` (the params must be there too); fp32 throughout,
    whatever TF32 flags the caller set."""
    with full_fp32():
        x = images.to(torch.float32).permute(0, 3, 1, 2)  # NCHW
        for i, (_, sh, sw) in enumerate(_CONV_PLAN):
            top, bottom = same_pads(x.shape[2], 3, sh)
            left, right = same_pads(x.shape[3], 3, sw)
            x = F.pad(x, (left, right, top, bottom))
            w = params[f"conv{i}_w"].permute(3, 2, 0, 1)  # HWIO → OIHW
            x = F.conv2d(x, w, params[f"conv{i}_b"], stride=(sh, sw))
            x = F.gelu(x, approximate="tanh")
        b = x.shape[0]
        # collapse the height axis into per-position features, h * 128 + c
        x = x.permute(0, 3, 2, 1).reshape(b, _SEQ_LEN, -1).transpose(1, 2)  # [B, 256, T]
        x = F.pad(x, same_pads(x.shape[2], _MIX_K, 1))
        x = F.conv1d(x, params["mix_w"].permute(2, 1, 0), params["mix_b"])  # WIO → OIW
        x = F.gelu(x, approximate="tanh").transpose(1, 2)  # [B, T, 256]
        return torch.addmm(params["out_b"], x.reshape(-1, _SEQ_WIDTH), params["out_w"]).reshape(
            b, _SEQ_LEN, N_CLASSES)


def ctc_greedy_decode(
    logits: np.ndarray,
) -> tuple[list[str], np.ndarray]:
    """[B, T, C] logits → (texts, confidences). Confidence is the mean
    max-softmax over the non-blank emission frames (0 when the decode is
    empty)."""
    logits = np.asarray(logits, np.float32)
    ids = logits.argmax(axis=2)  # [B, T]
    z = logits - logits.max(axis=2, keepdims=True)
    probs = np.exp(z)
    probs /= probs.sum(axis=2, keepdims=True)
    top = probs.max(axis=2)  # [B, T]
    texts, confs = [], []
    for row_ids, row_top in zip(ids, top):
        out, conf_frames, prev = [], [], BLANK_ID
        for t, i in enumerate(row_ids):
            if i != BLANK_ID and i != prev:
                out.append(int(i))
                conf_frames.append(float(row_top[t]))
            prev = int(i)
        texts.append(decode_ids(out))
        confs.append(float(np.mean(conf_frames)) if conf_frames else 0.0)
    return texts, np.asarray(confs, np.float32)


# -- training ------------------------------------------------------------------

def ctc_loss(logits: torch.Tensor, labels: torch.Tensor, label_paddings: torch.Tensor) -> torch.Tensor:
    """``optax.ctc_loss(logits, 0-paddings, labels, label_paddings,
    blank_id=0)``: one negative log-likelihood per sequence, every logit
    frame valid; [B, T, C] logits, [B, L] labels padded with paddings 1."""
    log_probs = F.log_softmax(logits, dim=-1).transpose(0, 1)  # [T, B, C]
    b, t = logits.shape[:2]
    input_lengths = torch.full((b,), t, dtype=torch.long, device=logits.device)
    target_lengths = (1.0 - label_paddings).sum(1).round().long()
    return F.ctc_loss(log_probs, labels.long(), input_lengths, target_lengths,
                      blank=BLANK_ID, reduction="none")


class OCROptimizer:
    """``optax.chain(clip_by_global_norm(1.0), adamw(warmup_cosine_decay_
    schedule(0, lr, warmup, steps, lr * 0.05)))`` with optax's AdamW
    defaults (b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-4 on every leaf,
    biases included, times the scheduled rate)."""

    def __init__(self, steps: int, lr: float, max_norm: float = 1.0):
        from evr_tpu_torch.training.variants import AdamW, warmup_cosine_decay

        self.max_norm = max_norm
        self.warmup = min(100, max(1, steps // 10))
        self.adamw = AdamW(warmup_cosine_decay(lr, self.warmup, steps, end_value=lr * 0.05))

    def init(self, params: dict) -> dict:
        return self.adamw.init(params)

    @torch.no_grad()
    def apply(self, params: dict, grads: dict, state: dict) -> None:
        """Update ``params`` in place."""
        from evr_tpu_torch.training.finetune import global_norm

        norm = global_norm(list(grads.values()))
        keep = norm < self.max_norm  # optax's select, without a read-back a step
        grads = {k: torch.where(keep, g, (g / norm) * self.max_norm) for k, g in grads.items()}
        self.adamw.apply(params, grads, state)


def grads_of(params: dict, images, labels, label_paddings) -> tuple[torch.Tensor, dict]:
    """(the batch's mean CTC loss, the gradient of every leaf) at ``params``
    (the JAX trainer's ``value_and_grad(loss_fn)``), the backward's
    convolutions in fp32 as the forward's."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with torch.enable_grad(), full_fp32():
        loss = ctc_loss(ocr_logits(leaves, images), labels, label_paddings).mean()
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def minibatch_indices(steps: int, batch: int, dataset_size: int, seed: int):
    """The JAX trainer's minibatch draws: ``default_rng(seed + 1).integers(
    0, dataset_size, (k, batch))`` in chunks of at most 100 steps; yields
    one [batch] index array a step."""
    rng = np.random.default_rng(seed + 1)
    done = 0
    while done < steps:
        k = min(100, steps - done)
        yield from rng.integers(0, dataset_size, size=(k, batch))
        done += k


def train_ocr(
    steps: int = 3000,
    batch: int = 64,
    dataset_size: int = 8192,
    lr: float = 1e-3,
    seed: int = 0,
    params: dict | None = None,
    log_every: int = 0,
    device=None,
    render=None,
) -> tuple[dict, dict]:
    """Train the recogniser on device-resident synthetic renders.

    The dataset is rendered once on the host and moved to ``device`` once
    (None: the card; pass "cpu" to train on the CPU); each step gathers its
    minibatch there. ``params`` (numpy arrays or tensors) default to
    ``init_ocr_params`` seeded with ``seed``; ``render`` draws the training
    and held-out lines (``make_dataset``). Returns (params on the device,
    {"loss": the mean loss of the last chunk of up to 100 steps, "acc":
    held-out exact-match accuracy})."""
    dev = resolve_device(device)
    imgs, labels, pads, _ = make_dataset(dataset_size, seed=seed, render=render)
    x = torch.from_numpy(imgs).to(dev)
    y = torch.from_numpy(labels).to(dev)
    yp = torch.from_numpy(pads).to(dev)
    if params is None:
        params = init_ocr_params(torch.Generator().manual_seed(seed))
    params = params_to(params, dev)
    opt = OCROptimizer(steps, lr)
    state = opt.init(params)
    chunk_losses: list[torch.Tensor] = []
    for step, idx in enumerate(minibatch_indices(steps, batch, dataset_size, seed)):
        if step % 100 == 0:
            chunk_losses = []
        i = torch.from_numpy(idx).to(dev)
        loss, grads = grads_of(params, x[i], y[i], yp[i])
        opt.apply(params, grads, state)
        chunk_losses.append(loss)
        done = step + 1
        if log_every and (done % log_every == 0 or done == steps):
            print(f"step {done}/{steps} loss {float(torch.stack(chunk_losses).mean()):.4f}")
    acc = eval_ocr(params, n=256, seed=seed + 99, render=render)
    return params, {
        "loss": float(torch.stack(chunk_losses).mean()) if chunk_losses else float("nan"),
        "acc": acc,
    }


def eval_ocr(params: dict, n: int = 256, seed: int = 123, render=None) -> float:
    """Exact-match accuracy on fresh (unseen-seed) synthetic renders, on the
    device the params are on."""
    imgs, _, _, texts = make_dataset(n, seed=seed, render=render)
    logits = _batched_logits(params, imgs)
    decoded, _ = ctc_greedy_decode(logits)
    return float(np.mean([d == t for d, t in zip(decoded, texts)]))


def _batched_logits(
    params: dict, imgs: np.ndarray, batch: int = 64
) -> np.ndarray:
    """Logits of [N, 32, 256, 1] crops in batches of ``batch`` on the params'
    device, the tail batch padded with zero crops (every row is computed on
    its own; the padding's rows are dropped)."""
    dev = next(iter(params.values())).device
    out = []
    with torch.inference_mode():
        for i in range(0, len(imgs), batch):
            chunkx = imgs[i : i + batch]
            n = len(chunkx)
            if n < batch:
                chunkx = np.concatenate(
                    [chunkx, np.zeros((batch - n, *chunkx.shape[1:]), chunkx.dtype)]
                )
            x = torch.from_numpy(np.ascontiguousarray(chunkx, np.float32)).to(dev)
            out.append(ocr_logits(params, x)[:n].cpu().numpy())
    return (
        np.concatenate(out)
        if out
        else np.zeros((0, _SEQ_LEN, N_CLASSES), np.float32)
    )


def save_checkpoint(params: dict, path=DEFAULT_CHECKPOINT, meta: dict | None = None):
    """The JAX package's ``.npz`` layout: fp32 arrays by name, the charset
    (and an optional JSON ``meta``) as uint8 bytes."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    flat = {
        k: (v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)).astype(np.float32)
        for k, v in params.items()
    }
    flat["__charset__"] = np.frombuffer(
        CHARSET.encode("utf-8"), np.uint8
    ).copy()
    if meta:
        import json

        flat["__meta__"] = np.frombuffer(
            json.dumps(meta).encode("utf-8"), np.uint8
        ).copy()
    np.savez_compressed(path, **flat)


def load_checkpoint(path=DEFAULT_CHECKPOINT) -> dict:
    """An ``.npz`` checkpoint (either package's) as fp32 CPU tensors
    (``params_to`` places them); a charset other than ``CHARSET`` raises."""
    path = pathlib.Path(path)
    if not path.exists():
        raise FileNotFoundError(
            f"OCR checkpoint {path} not found: train one with "
            "`python -m evr_tpu_torch.tools.train_ocr` (synthetic renders, no "
            "downloads needed)"
        )
    with np.load(path) as z:
        saved = z["__charset__"].tobytes().decode("utf-8")
        if saved != CHARSET:
            raise ValueError(
                "checkpoint charset differs from ingest.ocr.CHARSET: "
                "retrain or pin the matching code version"
            )
        return {
            k: torch.from_numpy(z[k].astype(np.float32))
            for k in z.files
            if not k.startswith("__")
        }


# -- detection -----------------------------------------------------------------

def detect_text_regions(
    gray_u8: np.ndarray,
    min_height: int = 10,
    max_height_frac: float = 0.35,
    min_aspect: float = 1.2,
    max_aspect: float = 40.0,
    min_fill: float = 0.15,
    max_regions: int = 8,
) -> list[tuple[int, int, int, int]]:
    """Text-line candidate boxes (x, y, w, h in pixels) from one grayscale
    frame. Gradient magnitude → Otsu threshold → wide horizontal close →
    connected components filtered by line-like geometry. Polarity-free."""
    import cv2

    h, w = gray_u8.shape
    # the pre-blur removes per-pixel sensor and compression noise before the
    # gradient; text edges are multi-pixel steps and survive it
    smooth = cv2.GaussianBlur(gray_u8, (3, 3), 0)
    gx = cv2.Sobel(smooth, cv2.CV_32F, 1, 0, ksize=3)
    gy = cv2.Sobel(smooth, cv2.CV_32F, 0, 1, ksize=3)
    mag = cv2.convertScaleAbs(np.sqrt(gx * gx + gy * gy))
    _, binary = cv2.threshold(mag, 0, 255, cv2.THRESH_BINARY + cv2.THRESH_OTSU)
    # fuse the characters of a line into one component
    kernel = cv2.getStructuringElement(cv2.MORPH_RECT, (15, 3))
    closed = cv2.morphologyEx(binary, cv2.MORPH_CLOSE, kernel)
    n, _, stats, _ = cv2.connectedComponentsWithStats(closed, connectivity=8)
    boxes = []
    for i in range(1, n):
        x, y, bw, bh, area = stats[i]
        if bh < min_height or bh > h * max_height_frac:
            continue
        aspect = bw / max(bh, 1)
        if not (min_aspect <= aspect <= max_aspect):
            continue
        if area / max(bw * bh, 1) < min_fill:
            continue
        boxes.append((int(x), int(y), int(bw), int(bh), int(area)))
    # largest-area candidates first, bounded
    boxes.sort(key=lambda b: -b[4])
    return [(x, y, bw, bh) for x, y, bw, bh, _ in boxes[:max_regions]]


# -- the Annotator -------------------------------------------------------------

class LocalOCRAnnotator:
    """Zero-egress OCR annotator in the reference's detection schema (label,
    bounding_box [x, y, w, h] normalised, confidence): the text-side sibling
    of ``ZeroShotObjectAnnotator``.

    Per frame the host detector proposes line boxes; every crop is staged to
    the recogniser's fixed input, and the whole folder's crops run through
    the convolution tower on ``device`` in batches of ``batch``
    (``annotate_batch``). Decodes shorter than ``min_chars`` or below
    ``min_conf`` are dropped. ``device``: None means the card (raises
    without one); pass "cpu" to run on the CPU. A device failure raises."""

    def __init__(
        self,
        params: dict | None = None,
        checkpoint=DEFAULT_CHECKPOINT,
        min_conf: float = 0.35,
        min_chars: int = 2,
        max_regions: int = 8,
        batch: int = 64,
        device=None,
    ):
        self.device = resolve_device(device)
        self.params = params_to(params if params is not None else load_checkpoint(checkpoint),
                                self.device)
        self.min_conf = min_conf
        self.min_chars = min_chars
        self.max_regions = max_regions
        self.batch = batch

    def _frame_crops(self, gray_u8: np.ndarray):
        boxes = detect_text_regions(gray_u8, max_regions=self.max_regions)
        h, w = gray_u8.shape
        crops = []
        for x, y, bw, bh in boxes:
            # components hug the stroke gradient tightly; a small proportional
            # margin keeps the first and last glyph's outer edge inside the
            # crop (tight crops drop leading thin letters like 'f')
            m = max(2, bh // 8)
            x0, y0 = max(0, x - m), max(0, y - m)
            x1, y1 = min(w, x + bw + m), min(h, y + bh + m)
            crops.append(
                stage_crop(gray_u8[y0:y1, x0:x1].astype(np.float32) / 255.0)
            )
        return boxes, crops

    def _emit(self, boxes, texts, confs, width, height):
        dets = []
        for (x, y, bw, bh), text, conf in zip(boxes, texts, confs):
            text = text.strip()
            if len(text) < self.min_chars or conf < self.min_conf:
                continue
            dets.append(
                {
                    "label": text,
                    "bounding_box": [
                        x / width, y / height, bw / width, bh / height
                    ],
                    "confidence": round(float(conf), 4),
                }
            )
        return dets

    def frame_crops(self, paths) -> tuple[list, np.ndarray]:
        """Each frame's ``(lo, hi, boxes, (h, w))`` span of the stacked crops
        (None for a frame that does not decode) and the crops [N, 32, 256, 1]."""
        import cv2

        all_crops, spans = [], []
        for p in paths:
            img = cv2.imread(str(p), cv2.IMREAD_GRAYSCALE)
            if img is None:
                spans.append(None)
                continue
            boxes, crops = self._frame_crops(img)
            spans.append((len(all_crops), len(all_crops) + len(crops), boxes, img.shape))
            all_crops.extend(crops)
        stacked = (np.stack(all_crops)[..., None] if all_crops
                   else np.zeros((0, IMG_H, IMG_W, 1), np.float32))
        return spans, stacked

    def annotate_batch(self, paths) -> list[dict]:
        spans, stacked = self.frame_crops(paths)
        if len(stacked):
            logits = _batched_logits(self.params, stacked, batch=self.batch)
            texts, confs = ctc_greedy_decode(logits)
        else:
            texts, confs = [], np.zeros((0,), np.float32)
        results = []
        for span in spans:
            if span is None:
                results.append(
                    {"text_detections": [], "object_detections": []}
                )
                continue
            lo, hi, boxes, (h, w) = span
            results.append(
                {
                    "text_detections": self._emit(
                        boxes, texts[lo:hi], confs[lo:hi], w, h
                    ),
                    "object_detections": [],
                }
            )
        return results

    def __call__(self, image_path) -> dict:
        (out,) = self.annotate_batch([image_path])
        return out
