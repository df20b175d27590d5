"""Dataset preparation (counterpart of ``evr_tpu/data_prep``). Ported so
far: the test-set caption translation and the captioners (``captioning``:
the template, local HuggingFace and prefix captioners, ``caption_folder``);
the splits, token audit, CLIPScore and augmentation tools wait for ROADMAP
item A20."""

from .captioning import (
    Captioner,
    HFCaptioner,
    PrefixCaptioner,
    TemplateCaptioner,
    caption_folder,
)
from .translate_testset import translate_testset_csv

__all__ = [
    "Captioner",
    "HFCaptioner",
    "PrefixCaptioner",
    "TemplateCaptioner",
    "caption_folder",
    "translate_testset_csv",
]
