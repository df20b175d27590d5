from .clip import (
    CLIPConfig,
    TextConfig,
    VisionConfig,
    clip_forward,
    encode_image,
    encode_staged_u8,
    encode_text,
    init_clip_params,
)
from .classifier import ClassifierConfig, classifier_forward, init_classifier_params
from .convert import params_from_numpy
from .quant import quantize_clip_params, quantized_linear
from .variants import MODEL_REGISTRY, get_model_config

__all__ = [
    "CLIPConfig",
    "ClassifierConfig",
    "classifier_forward",
    "init_classifier_params",
    "TextConfig",
    "VisionConfig",
    "clip_forward",
    "encode_image",
    "encode_staged_u8",
    "encode_text",
    "init_clip_params",
    "params_from_numpy",
    "quantize_clip_params",
    "quantized_linear",
    "MODEL_REGISTRY",
    "get_model_config",
]
