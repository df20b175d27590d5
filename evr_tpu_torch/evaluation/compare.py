"""Multi-model retrieval comparison harness.

Counterpart of ``evr_tpu/evaluation/compare.py``. Reference:
``ModelComparison`` (`compare_models.py:1278-1313`) evaluates a zoo of
models (fine-tuned CLIP, OpenAI CLIP, OpenCLIP ViT-H-14, FLAVA,
ViT+projection) one at a time in memory-efficient load→eval→unload mode,
dumping JSON/Excel/matplotlib comparisons.

A model is any ``ModelAdapter`` (encode_image_files / encode_texts);
``EngineAdapter`` wraps the port's ``EmbeddingEngine`` (any registered
checkpoint), and HF models (``hf_adapters``) can be wrapped without the
harness knowing. The similarity GEMM of each evaluation runs on
``ModelComparison``'s ``device`` (None: the card; "cpu" on request).
Results are written as JSON, CSV, the reference's three-sheet workbook, and
matplotlib bar charts where matplotlib is installed (``save_charts`` returns
None without it, as in the JAX package).
"""

from __future__ import annotations

import gc
import json
import pathlib
import time
from typing import Callable, Protocol

import numpy as np

from .datasets import CaptionsTable
from .retrieval import calculate_metrics, evaluate_retrieval


class ModelAdapter(Protocol):
    def encode_image_files(self, paths: list[str]) -> np.ndarray: ...

    def encode_texts(self, texts: list[str]) -> np.ndarray: ...


class EngineAdapter:
    """Adapter over ``index.EmbeddingEngine`` (optionally switching to a
    registered fine-tuned checkpoint first); it encodes on the engine's
    device."""

    def __init__(self, engine, model_name: str | None = None):
        self.engine = engine
        self.model_name = model_name

    def _activate(self):
        if self.model_name is not None:
            self.engine.set_active_model(self.model_name)

    def encode_image_files(self, paths):
        self._activate()
        return self.engine.encode_image_files(paths, normalise=True)

    def encode_texts(self, texts):
        self._activate()
        return self.engine.encode_texts(texts, normalise=True)


class ModelComparison:
    def __init__(
        self,
        output_dir="comparison_results",
        log: Callable[[str], None] = print,
        device=None,
    ):
        self.output_dir = pathlib.Path(output_dir)
        self.device = device
        self.factories: dict[str, Callable[[], ModelAdapter]] = {}
        self.results: dict[str, dict] = {}
        self.log = log

    def register(self, name: str, factory: Callable[[], ModelAdapter]) -> None:
        """Register lazily so load→eval→unload keeps one model in memory."""
        self.factories[name] = factory

    def evaluate_model(self, name: str, dataset: CaptionsTable) -> dict:
        adapter = self.factories[name]()
        t0 = time.time()
        image_feats = adapter.encode_image_files(dataset.ordered_paths)
        encode_image_time = time.time() - t0
        t0 = time.time()
        text_feats = adapter.encode_texts(dataset.captions)
        encode_text_time = time.time() - t0

        result = evaluate_retrieval(
            image_feats, text_feats, dataset.caption_image_ids, dataset.image_ids,
            device=self.device,
        )
        result["encode_image_seconds"] = encode_image_time
        result["encode_text_seconds"] = encode_text_time

        if dataset.caption_gt_ids:  # multi-GT P@K pass (Excel test sets)
            id_to_row = {image_id: i for i, image_id in enumerate(dataset.image_ids)}
            sims = image_feats @ text_feats.T  # [N, M]
            gt_indices = [
                [id_to_row[g] for g in gts if g in id_to_row]
                for gts in dataset.caption_gt_ids
            ]
            multi_metrics, _ = calculate_metrics(sims.T, gt_indices)
            result["multi_gt"] = multi_metrics

        del adapter
        gc.collect()
        return result

    def run_evaluation(self, dataset: CaptionsTable, models: list[str] | None = None) -> dict:
        names = models or list(self.factories)
        for name in names:
            self.log(f"evaluating {name} on {len(dataset.image_ids)} images / "
                     f"{len(dataset.captions)} captions")
            self.results[name] = self.evaluate_model(name, dataset)
            m = self.results[name]["mean"]
            self.log(
                f"  {name}: rsum={m['rsum']:.3f} R@1(mean)={m['R@1']:.3f} "
                f"MRR(mean)={m['MRR']:.3f}"
            )
        return self.results

    # -- outputs ----------------------------------------------------------
    def save_json(self, filename: str = "comparison_results.json") -> pathlib.Path:
        self.output_dir.mkdir(parents=True, exist_ok=True)
        path = self.output_dir / filename
        payload = {
            name: {k: v for k, v in res.items() if not k.endswith("_ranks")}
            for name, res in self.results.items()
        }
        path.write_text(json.dumps(payload, indent=2))
        return path

    def save_csv(self, filename: str = "comparison_results.csv") -> pathlib.Path:
        """Tabular export (the reference writes Excel; CSV opens everywhere
        and needs no optional engine)."""
        import csv

        self.output_dir.mkdir(parents=True, exist_ok=True)
        path = self.output_dir / filename
        metrics = ["R@1", "R@5", "R@10", "MRR", "Median_Rank", "Mean_Rank"]
        with open(path, "w", newline="") as f:
            writer = csv.writer(f)
            writer.writerow(["model", "direction"] + metrics + ["rsum"])
            for name, res in self.results.items():
                for direction in ("t2i", "i2t", "mean"):
                    row = [name, direction] + [res[direction][m] for m in metrics]
                    row.append(res["mean"]["rsum"] if direction == "mean" else "")
                    writer.writerow(row)
        return path

    def save_xlsx(self, filename: str = "comparison_results.xlsx") -> pathlib.Path:
        """Multi-sheet Excel report, matching the reference's
        ``comparison_results.xlsx`` layout (`compare_models.py:1359-1381`:
        Text-to-Image / Image-to-Text / Mean Metrics sheets, one row per
        model) — written by the stdlib OOXML writer, no openpyxl."""
        from evr_tpu_torch.utils.xlsx import write_xlsx

        self.output_dir.mkdir(parents=True, exist_ok=True)
        metrics = ["R@1", "R@5", "R@10", "MRR", "Median_Rank", "Mean_Rank"]
        sheets = {}
        for title, key in (
            ("Text-to-Image", "t2i"),
            ("Image-to-Text", "i2t"),
            ("Mean Metrics", "mean"),
        ):
            header = [""] + metrics + (["rsum"] if key == "mean" else [])
            rows = [header]
            for name, res in self.results.items():
                row = [name] + [float(res[key][m]) for m in metrics]
                if key == "mean":
                    row.append(float(res["mean"]["rsum"]))
                rows.append(row)
            sheets[title] = rows
        return write_xlsx(self.output_dir / filename, sheets)

    def save_charts(self, filename: str = "comparison_chart.png") -> pathlib.Path | None:
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return None
        self.output_dir.mkdir(parents=True, exist_ok=True)
        metrics = ["R@1", "R@5", "R@10", "MRR"]
        names = list(self.results)
        fig, axes = plt.subplots(1, 2, figsize=(12, 4))
        for ax, direction in zip(axes, ("t2i", "i2t")):
            x = np.arange(len(metrics))
            width = 0.8 / max(1, len(names))
            for i, name in enumerate(names):
                vals = [self.results[name][direction][m] for m in metrics]
                ax.bar(x + i * width, vals, width, label=name)
            ax.set_xticks(x + 0.4 - width / 2)
            ax.set_xticklabels(metrics)
            ax.set_title({"t2i": "Text→Image", "i2t": "Image→Text"}[direction])
            ax.set_ylim(0, 1)
        axes[0].legend(fontsize=7)
        path = self.output_dir / filename
        fig.tight_layout()
        fig.savefig(path, dpi=120)
        plt.close(fig)
        return path

    def format_table(self) -> str:
        lines = []
        header = f"{'model':<24} {'dir':<5} " + " ".join(f"{m:>8}" for m in ("R@1", "R@5", "R@10", "MRR", "MedR", "MeanR"))
        lines.append(header)
        lines.append("-" * len(header))
        for name, res in self.results.items():
            for direction in ("t2i", "i2t", "mean"):
                d = res[direction]
                lines.append(
                    f"{name:<24} {direction:<5} "
                    + " ".join(
                        f"{d[m]:>8.4f}"
                        for m in ("R@1", "R@5", "R@10", "MRR", "Median_Rank", "Mean_Rank")
                    )
                )
            lines.append(f"{'':<24} rsum  {res['mean']['rsum']:>8.4f}")
        return "\n".join(lines)
