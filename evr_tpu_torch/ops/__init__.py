from .attention import flash_attention
from .layernorm import fused_layer_norm
from .preprocess import (
    CLIP_MEAN,
    CLIP_STD,
    load_image_host,
    preprocess_batch,
    preprocess_for_model,
    stage_array_fast,
    stage_image_fast,
)
from .retrieval import fused_topk
from .topk import cosine_topk, merge_topk

__all__ = [
    "CLIP_MEAN",
    "CLIP_STD",
    "load_image_host",
    "preprocess_batch",
    "preprocess_for_model",
    "stage_array_fast",
    "stage_image_fast",
    "cosine_topk",
    "flash_attention",
    "fused_layer_norm",
    "fused_topk",
    "merge_topk",
]
