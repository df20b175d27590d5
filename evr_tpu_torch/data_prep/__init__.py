"""Dataset preparation (counterpart of ``evr_tpu/data_prep``). Ported so
far: the test-set caption translation; the splits, token audit, CLIPScore,
augmentation and captioning tools wait for ROADMAP item A20."""

from .translate_testset import translate_testset_csv

__all__ = ["translate_testset_csv"]
