"""EmbeddingEngine — model registry + batched device encoding (PyTorch).

Counterpart of ``evr_tpu/index/engine.py``: staged uint8 frames go through
``encode_staged_u8`` (folded normalisation, CLS-only final block), text
through ``encode_text(eot_fast_final=True)``; batches are padded to
``batch_size``; text features are cached per (model, query); models can be
registered and switched at run time.

On the card the compute dtype is bfloat16 and every residual block but the
last runs through the hand-written kernels K1 and K2 (K3 with int8 weights),
or, under a ``cfg`` with ``attn_impl="flash"``, through K6 for its attention;
on the CPU it is float32 and the blocks take the plain composition.

Checkpoints: ``from_checkpoint`` and ``load_finetuned`` read a reference
``.pt`` file (the OpenAI layout, ``models.torch_import``) or the port
Trainer's own ``.pt`` file (``training.finetune``), told apart by their keys
(``load_torch_checkpoint``); a fine-tuned model's classifier head serves
through ``classify``. The JAX package's orbax directories need JAX and are
refused.

``moe`` (a ``models.moe.MoEConfig``) switches every encode to the sparse
MoE towers, as in the JAX engine: staged frames are normalised and encoded
by ``encode_image_moe`` (no folded stem), text by ``encode_text_moe``, the
last block in full; on the card each block's attention half runs K1 and
each dense block's MLP half K2. A self-describing MoE trainer file
(``payload["moe"]``) builds such an engine through ``from_checkpoint``;
int8 weights with MoE raise.

With a ``mesh`` (``parallel.mesh``, one process) every encode batch is split
evenly over the slots of ``mesh_axis``: each slot encodes its rows on its
device (K1/K2, or K3a/K3b on int8 weights, on the card) with the params of
that device, held once per distinct device, and the rows come back in slot
order. ``batch_size`` must divide over the axis, as in the JAX package; a
text batch is padded with empty rows to a multiple of the slots.

Image files: ``preprocess_mode="fast"`` stages a folder of JPEGs (what
ingest writes) through the native stager (``evr_tpu_torch.native``: cv2
decode, Pillow's two-pass bicubic resize in C++, the staging of the next
chunk overlapped with the encode of this one) and any other folder or file
list with cv2 (``ops.preprocess.stage_image_fast``); ``"pil"`` preprocesses
on the host with PIL (``ops.preprocess.load_image_host``) and encodes the
float pixels through ``models.clip.encode_image``. A stager that cannot be
built raises; a file that cannot be decoded is skipped by index.
"""

from __future__ import annotations

import pathlib
from typing import Callable

import numpy as np
import torch

from evr_tpu_torch.models.classifier import ClassifierConfig, classifier_forward
from evr_tpu_torch.models.clip import (
    CLIPConfig,
    encode_staged_u8,
    encode_text,
    init_clip_params,
)
from evr_tpu_torch.models.convert import params_from_numpy
from evr_tpu_torch.models.moe import MoEConfig, image_features, init_moe_clip_params, text_features
from evr_tpu_torch.models.quant import quantize_clip_params
from evr_tpu_torch.models.variants import get_model_config
from evr_tpu_torch.ops.preprocess import CLIP_MEAN, CLIP_STD, load_image_host, stage_image_fast
from evr_tpu_torch.tokenizer import get_default_tokenizer
from evr_tpu_torch.utils.device import resolve_device


def normalise_u8(staged_u8: torch.Tensor) -> torch.Tensor:
    """uint8 frames → CLIP-normalised fp32 pixels, as the JAX engine computes
    them: x / 255, minus the mean, over the std."""
    dev = staged_u8.device
    mean = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=dev)
    std = torch.tensor(CLIP_STD, dtype=torch.float32, device=dev)
    return (staged_u8.float() / 255.0 - mean) / std


IMAGE_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")
PARAMS_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": None}
PREPROCESS_MODES = ("fast", "pil")


def load_torch_checkpoint(path, prefer_ema: bool = False) -> dict:
    """A fine-tune checkpoint file for serving, whatever its kind, as
    ``{"clip": params, "classifier": params or None, "moe": MoEConfig or
    None}`` (``moe`` rebuilt from a self-describing MoE trainer file's
    ``payload["moe"]``, every field of it):

    - the port Trainer's ``.pt`` (``best_model.pt``, ``final_checkpoint.pt``:
      a dict with ``params``, ``opt_state`` and ``step``), the counterpart of
      the JAX package's orbax checkpoint: its params, or with ``prefer_ema=True`` its
      EMA (``payload["ema"]``, written when training ran with
      ``ema_decay > 0``) where it has one. The file is memory-mapped, so the
      optimizer moments it also holds are never read. A LoRA trainer's file
      (its params hold ``lora``) raises ``ValueError``: its ``clip`` is the
      untrained base, and the model it trained is in ``lora_merged.pt``;
    - a dict whose ``params`` hold ``clip`` (``tools.distill``'s
      ``student.pt``) or a bare CLIP tree (``tools.finetune``'s
      ``lora_merged.pt``), as the JAX package's ``load_orbax_checkpoint``
      reads such payloads;
    - otherwise a reference ``.pt`` (``models.torch_import``), which holds no
      EMA.

    A directory (an orbax checkpoint of the JAX package) raises."""
    from evr_tpu_torch.models.torch_import import checkpoint_from_blob, read_torch_file

    if pathlib.Path(path).is_dir():
        raise NotImplementedError(
            f"{path} is a directory: orbax checkpoints need JAX; the port reads torch "
            "files only (a reference .pt or the port Trainer's)")
    blob = read_torch_file(path)
    if not (isinstance(blob, dict) and isinstance(blob.get("params"), dict)):
        out = checkpoint_from_blob(blob)
        return {"clip": out["clip"], "classifier": out["classifier"], "moe": None}
    moe = None
    if blob.get("moe"):
        moe = MoEConfig(**{k: type(getattr(MoEConfig(), k))(v) for k, v in blob["moe"].items()})
    params = blob["params"]
    if prefer_ema and blob.get("ema") is not None:
        params = blob["ema"]
    if "lora" in params:
        raise ValueError(
            f"{path} is a LoRA trainer checkpoint: its 'clip' params are the untrained base and "
            "its adapters are unmerged; serve the merged model, <save-dir>/lora_merged.pt "
            "(tools.finetune writes it), or Trainer.merged_clip_params()")
    if "clip" in params:
        return {"clip": params["clip"], "classifier": params.get("classifier"), "moe": moe}
    if all(k in params for k in ("visual", "text", "logit_scale")):
        return {"clip": params, "classifier": None, "moe": moe}
    raise ValueError(f"{path}: 'params' holds neither 'clip' nor a CLIP tree")


class EmbeddingEngine:
    """Batched CLIP encoder with runtime model switching."""

    def __init__(
        self,
        model_name: str = "ViT-B/32",
        params=None,
        cfg: CLIPConfig | None = None,
        batch_size: int = 256,
        rng_seed: int = 0,
        params_dtype: str = "float32",
        device=None,
        preprocess_mode: str = "fast",
        mesh=None,
        mesh_axis: str = "data",
        moe: MoEConfig | None = None,
    ):
        """``params``: a nested dict of numpy arrays or tensors in the JAX
        package's layout; None draws random weights from ``rng_seed`` (MoE
        towers under ``moe``, ``models.moe.init_moe_clip_params``).
        ``cfg``: the model's configuration, ``get_model_config(model_name)``
        when None (pass one to serve another route, e.g. ``attn_impl="flash"``).
        ``device``: None means the card (raises without one); pass "cpu" to
        run on the CPU. ``params_dtype``: "float32", "bfloat16" or "int8"
        serving weights (``_cast_params``). ``preprocess_mode``: "fast" or
        "pil", how image files are staged (module docstring). ``mesh``: split
        each encode batch over the slots of ``mesh_axis`` (module docstring);
        ``device`` is then the first slot's. ``moe``: encode through the
        MoE towers (module docstring)."""
        if moe is not None and params_dtype == "int8":
            raise NotImplementedError("int8 serving weights are not supported for MoE towers")
        if params_dtype not in PARAMS_DTYPES:
            raise ValueError(
                f"unknown params_dtype {params_dtype!r} (supported: {sorted(PARAMS_DTYPES)})"
            )
        if preprocess_mode not in PREPROCESS_MODES:
            raise ValueError(
                f"unknown preprocess_mode {preprocess_mode!r} (supported: {PREPROCESS_MODES})"
            )
        self.preprocess_mode = preprocess_mode
        self._native_stager = None
        self.mesh = mesh
        self.mesh_axis = mesh_axis
        self._replicas: dict = {}
        if mesh is not None:
            n_shards = mesh.axis_size(mesh_axis)
            if mesh.process_count > 1:
                raise NotImplementedError("EmbeddingEngine(mesh=...) takes a one-process mesh")
            if batch_size % n_shards != 0:
                raise ValueError(
                    f"batch_size {batch_size} must divide evenly over the "
                    f"{n_shards}-way '{mesh_axis}' mesh axis")
            device = mesh.slot_devices[mesh.local_slots[0]]
        self.device = resolve_device(device)
        self.model_name = model_name
        self.cfg = cfg or get_model_config(model_name)
        self.compute_dtype = torch.bfloat16 if self.device.type == "cuda" else torch.float32
        self.batch_size = batch_size
        self.tokenizer = get_default_tokenizer()
        self.params_dtype = params_dtype
        self.moe = moe
        if params is None:
            params = (init_moe_clip_params(rng_seed, self.cfg, moe) if moe is not None
                      else init_clip_params(rng_seed, self.cfg))
        self.models: dict[str, dict] = {
            "original": {"clip": self._cast_params(params), "classifier": None}
        }
        self.active_model = "original"
        self._text_cache: dict[tuple[str, str], np.ndarray] = {}

    def _cast_params(self, params):
        """The engine's serving weight format applied to a CLIP params tree:
        ``float32`` and ``bfloat16`` cast every floating leaf; ``int8``
        quantizes the block linears from fp32 (``models.quant``) and leaves
        every other leaf in the dtype it had."""
        params = params_from_numpy(params, self.device, PARAMS_DTYPES[self.params_dtype])
        if self.params_dtype == "int8":
            return quantize_clip_params(params)
        return params

    @classmethod
    def from_checkpoint(
        cls, checkpoint_path, model_name: str = "ViT-B/32", name: str = "finetuned",
        prefer_ema: bool = False, **engine_kwargs,
    ) -> "EmbeddingEngine":
        """An engine serving ``checkpoint_path`` (``load_torch_checkpoint``):
        built for ``model_name``'s configuration (not the file's), the model
        registered as ``name`` and made active. A self-describing MoE file
        builds the engine with its ``MoEConfig`` (its params also the
        "original" model, as in the JAX engine)."""
        blob = load_torch_checkpoint(checkpoint_path, prefer_ema=prefer_ema)
        if blob["moe"] is not None:
            engine = cls(model_name, params=blob["clip"], moe=blob["moe"], **engine_kwargs)
        else:
            engine = cls(model_name, **engine_kwargs)
        engine._register_blob(name, blob)
        engine.set_active_model(name)
        return engine

    # -- model registry ---------------------------------------------------
    def register_model(self, name: str, clip_params, classifier=None,
                       classifier_cfg: ClassifierConfig | None = None) -> None:
        """The classifier head, where there is one, moves to the engine's
        device in its own dtype: the serving weight format casts the towers
        only."""
        self.models[name] = {
            "clip": self._cast_params(clip_params),
            "classifier": None if classifier is None else params_from_numpy(classifier, self.device),
            "classifier_cfg": classifier_cfg or ClassifierConfig(embed_dim=self.cfg.embed_dim),
        }

    def load_finetuned(self, checkpoint_path, name: str = "finetuned", prefer_ema: bool = False) -> None:
        """Register a fine-tune checkpoint file as ``name`` (not made
        active); ``prefer_ema``: see ``load_torch_checkpoint``. An MoE file
        needs an engine built with its config (``from_checkpoint``), and a
        dense file a dense engine: either mismatch raises ``ValueError``."""
        self._register_blob(name, load_torch_checkpoint(checkpoint_path, prefer_ema=prefer_ema))

    def _register_blob(self, name: str, blob: dict) -> None:
        if blob["moe"] is not None and self.moe is None:
            raise ValueError("MoE checkpoint: build the engine with its config "
                             "(EmbeddingEngine.from_checkpoint, or EmbeddingEngine(moe=...))")
        if blob["moe"] != self.moe:
            raise ValueError(f"checkpoint MoEConfig {blob['moe']} != engine's {self.moe}")
        self.register_model(name, blob["clip"], blob["classifier"])

    def set_active_model(self, name: str) -> bool:
        if name not in self.models:
            return False
        self.active_model = name
        return True

    def available_models(self) -> list[str]:
        return list(self.models)

    def set_params_dtype(self, params_dtype: str) -> None:
        """Re-cast every registered model's weights in place (fp32/bf16 →
        int8 promotion after the boot gate passes —
        ``models.quant_gate.auto_params_dtype``). int8 cannot widen back to
        a float format (quantization discards precision) and raises."""
        if params_dtype not in PARAMS_DTYPES:
            raise ValueError(f"unknown params_dtype {params_dtype!r}")
        if self.moe is not None and params_dtype == "int8":
            raise NotImplementedError("int8 serving weights are not supported for MoE towers")
        if self.params_dtype == "int8" and params_dtype != "int8":
            raise ValueError(
                f"cannot widen int8 weights back to {params_dtype}; "
                "rebuild the engine from the checkpoint"
            )
        self.params_dtype = params_dtype
        for slot in self.models.values():
            slot["clip"] = self._cast_params(slot["clip"])
        self._text_cache.clear()

    @property
    def params(self):
        return self.models[self.active_model]["clip"]

    # -- text ------------------------------------------------------------
    def encode_texts(self, texts, normalise: bool = True) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        tokens = self.tokenizer(texts, context_length=self.cfg.text.context_length)
        if self.moe is not None:
            out = self._encode(lambda p, cfg, x, dtype: text_features(p, cfg, self.moe, x, dtype)[0], tokens)
        else:
            out = self._encode(
                lambda p, cfg, x, dtype: encode_text(p, cfg, x, dtype=dtype, eot_fast_final=True), tokens)
        if normalise:
            out = out / np.maximum(np.linalg.norm(out, axis=-1, keepdims=True), 1e-12)
        return out

    def get_text_features(self, query: str) -> np.ndarray:
        """Cached single-query text features."""
        key = (self.active_model, query)
        if key not in self._text_cache:
            self._text_cache[key] = self.encode_texts([query])[0]
        return self._text_cache[key]

    def clear_text_cache(self) -> None:
        self._text_cache.clear()

    # -- images ----------------------------------------------------------
    def _pad_batch(self, arr: np.ndarray) -> tuple[np.ndarray, int]:
        n = len(arr)
        if n == self.batch_size:
            return arr, n
        pad = np.zeros((self.batch_size - n,) + arr.shape[1:], dtype=arr.dtype)
        return np.concatenate([arr, pad], axis=0), n

    def _encode_batches(self, arr: np.ndarray, encode, normalise: bool, pad: bool = True) -> np.ndarray:
        """``encode(params, cfg, x, dtype=)`` over ``arr`` in batches of
        ``batch_size`` on the engine's device, the last one padded to it
        unless ``pad`` is False → [N, D] float32 on the host."""
        outs = []
        for i in range(0, len(arr), self.batch_size):
            chunk = arr[i : i + self.batch_size]
            batch, n = self._pad_batch(chunk) if pad else (chunk, len(chunk))
            outs.append(self._encode(encode, batch)[:n])
        out = (
            np.concatenate(outs, axis=0)
            if outs
            else np.zeros((0, self.cfg.embed_dim), np.float32)
        )
        if normalise:
            out = out / np.maximum(np.linalg.norm(out, axis=-1, keepdims=True), 1e-12)
        return out

    def _params_on(self, device: torch.device):
        """The active model's params on ``device``: the registry's own on the
        engine's device, a copy for each other distinct device, made again
        when the active params change."""
        if device == self.device:
            return self.params
        held = self._replicas.get(device)
        if held is None or held[0] is not self.params:
            held = self._replicas[device] = (self.params, params_from_numpy(self.params, device))
        return held[1]

    def _encode(self, encode, batch: np.ndarray) -> np.ndarray:
        """``encode(params, cfg, x, dtype=)`` over ``batch`` → [n, D] float32
        on the host: on the engine's device, or split over the mesh's slots
        (rows padded to a multiple of them) and gathered in slot order."""
        with torch.inference_mode():
            if self.mesh is None:
                x = torch.from_numpy(np.ascontiguousarray(batch)).to(self.device)
                return encode(self.params, self.cfg, x, dtype=self.compute_dtype).cpu().numpy()
            slots = self.mesh.leaders(self.mesh_axis)
            n = len(batch)
            per = -(-n // len(slots))
            if per * len(slots) != n:
                pad = np.zeros((per * len(slots) - n,) + batch.shape[1:], dtype=batch.dtype)
                batch = np.concatenate([batch, pad])
            outs = []
            for i, s in enumerate(slots):
                dev = self.mesh.slot_devices[s]
                x = torch.from_numpy(np.ascontiguousarray(batch[i * per:(i + 1) * per])).to(dev)
                outs.append(encode(self._params_on(dev), self.cfg, x, dtype=self.compute_dtype))
            return torch.cat([o.cpu() for o in outs]).numpy()[:n]

    def encode_staged_images(
        self, staged_u8: np.ndarray, normalise: bool = False, pad: bool = True
    ) -> np.ndarray:
        """uint8 [N, S, S, 3] (already resized/cropped) → [N, D] embeddings,
        in batches of ``batch_size``, the last one padded to it unless ``pad``
        is False (one query image encodes alone, not beside zero rows)."""
        encode = encode_staged_u8 if self.moe is None else self._encode_staged_moe
        return self._encode_batches(np.asarray(staged_u8), encode, normalise, pad)

    def _encode_staged_moe(self, params, cfg, staged_u8, dtype):
        """The JAX MoE engine's staged encode: x / 255, normalised, then the
        MoE vision tower (no folded stem)."""
        return image_features(params, cfg, self.moe, normalise_u8(staged_u8), dtype)[0]

    def text_tower(self, params, tokens: torch.Tensor) -> torch.Tensor:
        """Token ids on the device → unnormalised text features, every block
        in full (the one-call searchers' encode), on the engine's towers."""
        return text_features(params, self.cfg, self.moe, tokens, self.compute_dtype)[0]

    def image_tower(self, params, pixels: torch.Tensor) -> torch.Tensor:
        """Preprocessed pixels on the device → unnormalised image features,
        on the engine's towers."""
        return image_features(params, self.cfg, self.moe, pixels, self.compute_dtype)[0]

    def encode_pixels(self, pixels: np.ndarray, normalise: bool = False) -> np.ndarray:
        """Preprocessed float pixels [N, S, S, 3] (``load_image_host``,
        ``preprocess_batch``) → [N, D] through ``models.clip.encode_image``,
        in padded batches of ``batch_size``."""
        return self._encode_batches(np.asarray(pixels, np.float32),
                                    lambda p, cfg, x, dtype: image_features(p, cfg, self.moe, x, dtype)[0],
                                    normalise)

    def _encode_array(self, arr: np.ndarray) -> np.ndarray:
        """Encode a stacked batch that is either staged uint8 or
        preprocessed float pixels."""
        if arr.dtype == np.uint8:
            return self.encode_staged_images(arr)
        return self.encode_pixels(arr)

    def _ensure_native_stager(self):
        """The native stager (``evr_tpu_torch.native``), built at first use;
        raises when it cannot be built or loaded."""
        if self._native_stager is None:
            from evr_tpu_torch.native import NativeStager

            self._native_stager = NativeStager(self.cfg.vision.image_size)
        return self._native_stager

    def _stage_native(self, paths) -> tuple[np.ndarray, list[int]]:
        """Stage image files through the native stager → (uint8 [N, S, S,
        3], indices of the files that decoded)."""
        return self._ensure_native_stager().stage_batch(paths)

    def encode_image_files(self, paths, normalise: bool = False) -> np.ndarray:
        """Image files → [N, D]: "pil" through ``load_image_host`` and
        ``encode_pixels``, "fast" through ``stage_image_fast`` and
        ``encode_staged_images``. A file that cannot be read raises."""
        size = self.cfg.vision.image_size
        if self.preprocess_mode == "pil":
            out = self.encode_pixels(np.stack([load_image_host(p, size) for p in paths]))
        else:
            out = self.encode_staged_images(np.stack([stage_image_fast(p, size) for p in paths]))
        if normalise:
            out = out / np.maximum(np.linalg.norm(out, axis=-1, keepdims=True), 1e-12)
        return out

    def embed_folder(
        self,
        folder,
        normalise: bool = True,
        progress: Callable[[int, int], None] | None = None,
    ) -> tuple[np.ndarray, list[str]]:
        """Embed every image in a folder, sorted by filename (the order that
        aligns index rows with metadata frames). Returns (embeddings,
        frame_names). In "fast" mode a folder of JPEGs alone goes through
        the native stager, pipelined (``_embed_folder_pipelined``); any other
        folder, and "pil" mode, is staged file by file. Unreadable frames are
        skipped: their rows are absent and ``frame_names`` stays aligned."""
        folder = pathlib.Path(folder)
        candidates = sorted(
            p.name for p in folder.iterdir() if p.suffix.lower() in IMAGE_EXTENSIONS
        )
        if self.preprocess_mode == "fast" and all(
            n.lower().endswith((".jpg", ".jpeg")) for n in candidates
        ):
            return self._embed_folder_pipelined(folder, candidates, normalise, progress)

        size = self.cfg.vision.image_size
        names: list[str] = []
        embs = []
        staged_buf: list[np.ndarray] = []
        for pos, name in enumerate(candidates):
            try:
                if self.preprocess_mode == "pil":
                    staged_buf.append(load_image_host(folder / name, size))
                else:
                    staged_buf.append(stage_image_fast(folder / name, size))
            except OSError:
                continue
            names.append(name)
            if len(staged_buf) == self.batch_size:
                embs.append(self._encode_array(np.stack(staged_buf)))
                staged_buf.clear()
            if progress:
                progress(pos + 1, len(candidates))
        if staged_buf:
            embs.append(self._encode_array(np.stack(staged_buf)))
        emb = (
            np.concatenate(embs, axis=0)
            if embs
            else np.zeros((0, self.cfg.embed_dim), np.float32)
        )
        if normalise:
            emb = emb / np.maximum(np.linalg.norm(emb, axis=-1, keepdims=True), 1e-12)
        return emb.astype(np.float32), names

    def _embed_folder_pipelined(
        self,
        folder: pathlib.Path,
        candidates: list[str],
        normalise: bool,
        progress,
        chunk_frames: int | None = None,
    ) -> tuple[np.ndarray, list[str]]:
        """Chunked, double-buffered: the native stager stages chunk k + 1 on
        its thread pool while the card encodes chunk k, so host memory holds
        about two chunks. Failed decodes are skipped by index."""
        from concurrent.futures import ThreadPoolExecutor

        stager = self._ensure_native_stager()
        chunk = chunk_frames or max(self.batch_size * 4, 256)
        names: list[str] = []
        embs: list[np.ndarray] = []
        total = len(candidates)
        with ThreadPoolExecutor(max_workers=1) as ex:
            fut = ex.submit(stager.stage_batch, [folder / n for n in candidates[:chunk]])
            for start in range(0, total, chunk):
                batch, ok = fut.result()
                nxt = candidates[start + chunk : start + 2 * chunk]
                if nxt:
                    fut = ex.submit(stager.stage_batch, [folder / n for n in nxt])
                if ok:
                    embs.append(self.encode_staged_images(batch[ok]))
                    names.extend(candidates[start + i] for i in ok)
                if progress:
                    progress(min(start + chunk, total), total)
        emb = (
            np.concatenate(embs, axis=0)
            if embs
            else np.zeros((0, self.cfg.embed_dim), np.float32)
        )
        if normalise and len(emb):
            emb = emb / np.maximum(np.linalg.norm(emb, axis=-1, keepdims=True), 1e-12)
        return emb.astype(np.float32), names

    # -- classifier (violence/NSFW head) ----------------------------------
    def classify(self, features: np.ndarray) -> np.ndarray | None:
        """Class probabilities [N, num_classes] from the active model's
        classifier head, or None when the active model has none."""
        entry = self.models[self.active_model]
        if entry.get("classifier") is None:
            return None
        cfg = entry.get("classifier_cfg") or ClassifierConfig(embed_dim=self.cfg.embed_dim)
        x = torch.from_numpy(np.atleast_2d(np.asarray(features, np.float32))).to(self.device)
        with torch.inference_mode():
            logits = classifier_forward(entry["classifier"], cfg, x)
            return torch.softmax(logits, dim=-1).cpu().numpy()
