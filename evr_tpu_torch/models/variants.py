"""Model registry: the CLIP variants the reference stack uses (copy of
``evr_tpu``'s registry).

The serving path uses ViT-B/32 (`Backend/services/embedding_service.py:74`);
the evaluation harness additionally loads ViT-B/16-class and large towers
(`Backend/content/Test_compare_model/compare_models.py` model zoo). The @336
variant reuses the L/14 weights via positional-embedding interpolation
(``models.clip.interpolate_pos_embedding``, ``models.adapt``).
"""

from __future__ import annotations

from .clip import CLIPConfig, TextConfig, VisionConfig

MODEL_REGISTRY: dict[str, CLIPConfig] = {
    "ViT-B/32": CLIPConfig(
        embed_dim=512,
        vision=VisionConfig(image_size=224, patch_size=32, width=768, layers=12, heads=12),
        text=TextConfig(width=512, layers=12, heads=8),
    ),
    "ViT-B/16": CLIPConfig(
        embed_dim=512,
        vision=VisionConfig(image_size=224, patch_size=16, width=768, layers=12, heads=12),
        text=TextConfig(width=512, layers=12, heads=8),
    ),
    "ViT-L/14": CLIPConfig(
        embed_dim=768,
        vision=VisionConfig(image_size=224, patch_size=14, width=1024, layers=24, heads=16),
        text=TextConfig(width=768, layers=12, heads=12),
    ),
    "ViT-L/14@336px": CLIPConfig(
        embed_dim=768,
        vision=VisionConfig(image_size=336, patch_size=14, width=1024, layers=24, heads=16),
        text=TextConfig(width=768, layers=12, heads=12),
    ),
    # Tiny smoke-test geometry (NOT a reference model): lets every CLI —
    # finetune, pod_launch recipes, demo — run end-to-end on a dev box/CI
    # in seconds. Full 49408 vocab so the real tokenizer's ids stay in
    # range; towers are minimal.
    "ViT-Tiny-Test": CLIPConfig(
        embed_dim=32,
        vision=VisionConfig(image_size=64, patch_size=16, width=64, layers=2, heads=4),
        text=TextConfig(context_length=77, vocab_size=49408, width=64, layers=2, heads=4),
    ),
    # OpenCLIP laion2B tower in the reference's eval zoo (`compare_models.py`
    # model list); plain GELU rather than quickGELU.
    "ViT-H-14": CLIPConfig(
        embed_dim=1024,
        vision=VisionConfig(image_size=224, patch_size=14, width=1280, layers=32, heads=16),
        text=TextConfig(width=1024, layers=24, heads=16),
        activation="gelu",
    ),
}


def get_model_config(name: str, **overrides) -> CLIPConfig:
    import dataclasses

    cfg = MODEL_REGISTRY[name]
    return dataclasses.replace(cfg, **overrides) if overrides else cfg
