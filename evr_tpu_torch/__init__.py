"""evr_tpu_torch — the evr_tpu retrieval system on PyTorch and CUDA.

The port of ``evr_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100. It keeps
``evr_tpu``'s module layout and names, so each module's counterpart is easy to
find, and its parameter layout (nested dicts, ``[in, out]`` kernels, an HWIO
patch kernel), so weights carry across leaf by leaf
(``models.convert.params_from_numpy``). It imports neither JAX nor anything of
``evr_tpu``.

- ``evr_tpu_torch.models``     CLIP towers, the model registry, weight carry-over,
                               int8 weights and their serving gate
- ``evr_tpu_torch.tokenizer``  CLIP byte-level BPE tokenizer
- ``evr_tpu_torch.ops``        the fused block (forward and backward) and top-k
                               kernels (CUDA C++), top-k, staging
- ``evr_tpu_torch.index``      the frame index and the embedding engine
- ``evr_tpu_torch.ingest``     scene detection, frame extraction, frame records,
                               the ingest pipeline
- ``evr_tpu_torch.native``     the frame stager (C++ resize, built with g++)
- ``evr_tpu_torch.query``      frame metadata, event formatting, strategies
- ``evr_tpu_torch.serving``    the HTTP API and the upload jobs
- ``evr_tpu_torch.training``   contrastive fine-tuning (``Trainer``), its
                               losses, optimizer groups and caption data
- ``evr_tpu_torch.parallel``   meshes, the contrastive losses (one device and
                               global), the sharded search, FSDP, processes
- ``evr_tpu_torch.tools``      command-line tools (``tools.finetune``,
                               ``tools.ingest``, ``tools.index_tool``, ...)

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with no
card and no explicit CPU request they raise. Subpackages import lazily.
"""

import importlib

__version__ = "0.1.0"

_SUBPACKAGES = (
    "models", "tokenizer", "ops", "index", "ingest", "native", "query", "serving", "utils",
    "training", "parallel", "tools",
)


def __getattr__(name):
    if name in _SUBPACKAGES:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = list(_SUBPACKAGES)
