"""The PyTorch port stands alone: every module of ``evr_tpu_torch`` and
``chip_smoke`` imports in a process where JAX and the ``evr_tpu`` package
cannot be imported, and no file of the port names either of them."""

import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

_GUARDED_IMPORT = r"""
import importlib, pkgutil, sys

class Block:
    def find_spec(self, name, path, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "evr_tpu"):
            raise ImportError("blocked: " + name)

sys.meta_path.insert(0, Block())
for name in list(sys.modules):
    if name.split(".")[0] in ("jax", "jaxlib", "evr_tpu"):
        del sys.modules[name]
import evr_tpu_torch
names = [m.name for m in pkgutil.walk_packages(evr_tpu_torch.__path__, "evr_tpu_torch.")]
for name in names:
    importlib.import_module(name)
# the ANN slice: K7's wrapper, the three tiers and the offline CLI; the
# flash-attention slice: K6's wrapper; K8's wrapper; the query layer, the
# views and the served routes; the native stager, ingest, the upload jobs and
# the ingest tools; the benchmark harness, its tools, the workbook module, the
# test-set translation, the heads and the trainer variants; the trainer's
# levers, distillation and their tools; the mesh, the sharded search, FSDP,
# the process group, the sharded checkpoints and the launcher; the frame
# annotators (OCR, its trainer and CLI, the zero-shot object annotator); the
# second model family (SigLIP, its engine and trainer) and Whisper with its CLI
# and the zero-egress tokenizers; the MoE towers and expert parallelism, the
# prefix captioner, SCST, its CLI and the captioners of data prep
for name in ("evr_tpu_torch.ops.adc", "evr_tpu_torch.index.ivf", "evr_tpu_torch.index.pq",
             "evr_tpu_torch.index.ivfpq", "evr_tpu_torch.tools.index_tool",
             "evr_tpu_torch.ops.attention", "evr_tpu_torch.ops.layernorm",
             "evr_tpu_torch.query.text", "evr_tpu_torch.query.translate",
             "evr_tpu_torch.query.word_processing", "evr_tpu_torch.query.metadata",
             "evr_tpu_torch.query.temporal", "evr_tpu_torch.query.strategies",
             "evr_tpu_torch.viz", "evr_tpu_torch.viz.umap", "evr_tpu_torch.viz.tsne",
             "evr_tpu_torch.viz.projection", "evr_tpu_torch.serving.providers",
             "evr_tpu_torch.serving.ui", "evr_tpu_torch.serving.app",
             "evr_tpu_torch.serving.context", "evr_tpu_torch.serving.__main__",
             "evr_tpu_torch.utils.profiling", "evr_tpu_torch.native",
             "evr_tpu_torch.native.loader", "evr_tpu_torch.index.stream",
             "evr_tpu_torch.ingest", "evr_tpu_torch.ingest.scene", "evr_tpu_torch.ingest.frames",
             "evr_tpu_torch.ingest.annotate", "evr_tpu_torch.ingest.annotators",
             "evr_tpu_torch.ingest.best_frame", "evr_tpu_torch.ingest.transcripts",
             "evr_tpu_torch.ingest.pipeline", "evr_tpu_torch.serving.jobs",
             "evr_tpu_torch.tools.ingest", "evr_tpu_torch.tools.export_embeddings",
             "evr_tpu_torch.tools.retrieve", "evr_tpu_torch.evaluation",
             "evr_tpu_torch.evaluation.retrieval", "evr_tpu_torch.evaluation.datasets",
             "evr_tpu_torch.evaluation.classification", "evr_tpu_torch.evaluation.zeroshot",
             "evr_tpu_torch.evaluation.projection_align", "evr_tpu_torch.evaluation.compare",
             "evr_tpu_torch.evaluation.hf_adapters", "evr_tpu_torch.evaluation.diagnostics",
             "evr_tpu_torch.tools.evaluate", "evr_tpu_torch.tools.ab_compare",
             "evr_tpu_torch.tools.diagnose", "evr_tpu_torch.utils.xlsx", "evr_tpu_torch.data_prep",
             "evr_tpu_torch.data_prep.translate_testset", "evr_tpu_torch.models.heads",
             "evr_tpu_torch.training.variants", "evr_tpu_torch.training.lora",
             "evr_tpu_torch.training.muon", "evr_tpu_torch.training.gradcache",
             "evr_tpu_torch.training.distill", "evr_tpu_torch.tools.distill",
             "evr_tpu_torch.tools.train_sustained", "evr_tpu_torch.parallel.mesh",
             "evr_tpu_torch.parallel.sharded_search", "evr_tpu_torch.parallel.fsdp",
             "evr_tpu_torch.parallel.multihost", "evr_tpu_torch.training.sharded_ckpt",
             "evr_tpu_torch.tools.pod_launch", "evr_tpu_torch.parallel.tp",
             "evr_tpu_torch.parallel.pp", "evr_tpu_torch.parallel.sp",
             "evr_tpu_torch.parallel.sharded_ann", "evr_tpu_torch.ingest.ocr",
             "evr_tpu_torch.ingest.zeroshot", "evr_tpu_torch.tools.train_ocr",
             "evr_tpu_torch.tokenizer.fallbacks", "evr_tpu_torch.models.siglip",
             "evr_tpu_torch.index.siglip_engine", "evr_tpu_torch.training.siglip_train",
             "evr_tpu_torch.models.whisper", "evr_tpu_torch.tools.transcribe",
             "evr_tpu_torch.models.moe", "evr_tpu_torch.parallel.ep", "evr_tpu_torch.models.captioner",
             "evr_tpu_torch.training.scst", "evr_tpu_torch.tools.train_captioner",
             "evr_tpu_torch.data_prep.captioning"):
    assert name in names, name
import chip_smoke
assert not any(m.split(".")[0] in ("jax", "evr_tpu") for m in sys.modules)
print(len(names))
"""


def test_port_imports_without_jax_or_evr_tpu():
    out = subprocess.run(
        [sys.executable, "-c", _GUARDED_IMPORT], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    # every module of the port was imported: 50 by slice 5, 128 with the six
    # of the SigLIP and Whisper slice, 134 with the six of the MoE and
    # captioner slice (named above)
    assert int(out.stdout.strip().splitlines()[-1]) >= 134


def _port_files():
    files = sorted((ROOT / "evr_tpu_torch").rglob("*.py"))
    files += sorted((ROOT / "evr_tpu_torch").rglob("*.cu*"))
    files += sorted((ROOT / "evr_tpu_torch").rglob("*.cc"))
    return files + [ROOT / "chip_smoke.py"]


def test_port_files_name_neither_jax_nor_evr_tpu_modules():
    bad = re.compile(r"^\s*(import jax|from jax\b)|\bevr_tpu\.", re.M)
    offenders = [
        f"{p.relative_to(ROOT)}: {m.group(0).strip()}"
        for p in _port_files()
        for m in [bad.search(p.read_text())]
        if m
    ]
    assert not offenders, offenders
