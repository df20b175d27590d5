"""CLI entry: ``python -m evr_tpu_torch.serving --data-root data --port 5000``."""

import argparse


def build_engine(args, mesh=None):
    """The serving engine of ``parse_args``'s ``args``: an
    ``EmbeddingEngine`` (CLIP; its encode batches split over ``mesh``), or
    with ``--model-family siglip`` a ``SiglipEngine`` of ``--model`` (a
    SigLIP registry name) or of the local HF directory ``--siglip-hf``,
    tokenised by ``--siglip-tokenizer``'s local files or the zero-egress
    fallback. Unlike the JAX CLI, the SigLIP engine takes
    ``--params-dtype`` (the JAX CLI drops it). ``--checkpoint`` registers
    the file as "finetuned"; a self-describing MoE trainer file builds the
    engine on its ``MoEConfig`` and towers (the JAX CLI refuses such a
    file), which "original" then serves too."""
    if args.model_family == "siglip":
        from evr_tpu_torch.index.siglip_engine import SiglipEngine
        from evr_tpu_torch.models.siglip import get_siglip_config

        tokenize_fn = None
        if args.siglip_tokenizer:
            from transformers import SiglipTokenizer

            tok = SiglipTokenizer.from_pretrained(args.siglip_tokenizer, local_files_only=True)

            def tokenize_fn(texts):
                return tok(texts, padding="max_length", truncation=True, return_tensors="np")["input_ids"]

        kw = dict(tokenize_fn=tokenize_fn, params_dtype=args.params_dtype, device=args.device,
                  batch_size=args.batch_size)
        if args.siglip_hf:
            return SiglipEngine.from_hf(args.siglip_hf, **kw)
        return SiglipEngine(cfg=get_siglip_config(args.model), **kw)
    from evr_tpu_torch.index import EmbeddingEngine
    from evr_tpu_torch.index.engine import load_torch_checkpoint

    blob = load_torch_checkpoint(args.checkpoint, prefer_ema=args.use_ema) if args.checkpoint else None
    engine = EmbeddingEngine(
        args.model, device=args.device,
        params_dtype="float32" if args.params_dtype == "auto" else args.params_dtype,
        batch_size=args.batch_size, mesh=mesh,
        # a self-describing MoE trainer file: the engine's towers are its own
        params=None if blob is None or blob["moe"] is None else blob["clip"],
        moe=None if blob is None else blob["moe"],
    )
    if blob is not None:
        engine.register_model("finetuned", blob["clip"], blob["classifier"])
    return engine


def parse_args(argv=None) -> argparse.Namespace:
    """The CLI's arguments; a combination no engine serves exits at parse
    time (``--params-dtype auto`` and ``--checkpoint`` are CLIP's only)."""
    parser = argparse.ArgumentParser(description="evr_tpu_torch serving API")
    parser.add_argument("--data-root", default="data")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=5000)
    parser.add_argument("--model", default="ViT-B/32")
    parser.add_argument(
        "--checkpoint", default=None,
        help="a fine-tuned .pt checkpoint (a reference file or the port Trainer's "
        "best_model.pt / final_checkpoint.pt), registered as model 'finetuned' beside "
        "'original', which stays active",
    )
    parser.add_argument(
        "--use-ema", action="store_true",
        help="serve the EMA weights of a Trainer checkpoint (payload['ema'], written by "
        "finetune --ema-decay); the raw params when it has none",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="torch device for the towers and the index (default cuda; "
        "fails without a card unless cpu is given)",
    )
    parser.add_argument(
        "--index-dtype", choices=["float32", "bfloat16", "int8"], default="float32",
        help="device index storage dtype",
    )
    parser.add_argument(
        "--params-dtype", choices=["float32", "bfloat16", "int8", "auto"], default="float32",
        help="serving weight format: int8 quantizes the block linears (kernel K3 "
        "on the card); auto runs the rank-agreement gate over the ingested corpus "
        "at boot (models/quant_gate.py) and serves int8 only when it passes "
        "(bfloat16 otherwise)",
    )
    parser.add_argument(
        "--search-impl", choices=["xla", "pallas", "ivf", "ivfpq"], default="xla",
        help="index search: xla (GEMM + sort, exact), pallas (the fused streaming "
        "top-k kernel K4, exact), ivf (approximate list probing) or ivfpq (probed "
        "PQ codes with an exact re-rank)",
    )
    parser.add_argument(
        "--ivf-nprobe", type=int, default=32,
        help="lists probed per query under ivf/ivfpq (nprobe = clusters is exact)",
    )
    parser.add_argument(
        "--ivf-clusters", type=int, default=None,
        help="inverted-list count under ivf/ivfpq (default ~sqrt(N))",
    )
    parser.add_argument(
        "--ivfpq-host-store", action="store_true",
        help="ivfpq: the device holds only the PQ codes; the re-rank rows live in "
        "host memory as int8",
    )
    parser.add_argument(
        "--batch-window-ms", type=float, default=None,
        help="micro-batch window: concurrent text queries arriving within this many ms "
        "coalesce into one device dispatch (off when unset)",
    )
    parser.add_argument("--batch-size", type=int, default=256)
    parser.add_argument(
        "--shard-index", action="store_true",
        help="shard the frame index and the encode batches over a mesh of every local card",
    )

    parser.add_argument(
        "--transcriber", choices=["none", "assemblyai"], default="none",
        help="voice-transcription provider (assemblyai reads ASSEMBLYAI_API_KEY)",
    )
    parser.add_argument(
        "--frontend-dist", default=None,
        help="serve a built SPA (e.g. the reference React app's dist/) at /app/",
    )
    parser.add_argument(
        "--zeroshot-objects", action="store_true",
        help="annotate uploaded videos' object_detections zero-shot with the serving "
        "CLIP towers (COCO-80 vocabulary; ingest/zeroshot.py)",
    )
    parser.add_argument(
        "--local-ocr", default="auto", choices=("auto", "on", "off"),
        help="annotate uploaded videos' text_detections with the zero-egress OCR "
        "(ingest/ocr.py, on --device); auto = on when the package's checkpoint exists",
    )
    parser.add_argument(
        "--model-family", choices=["clip", "siglip"], default="clip",
        help="clip (EmbeddingEngine, --model a CLIP name) or siglip (SiglipEngine, --model a "
        "SigLIP registry name such as siglip-base-patch16-224, or --siglip-hf)",
    )
    parser.add_argument("--siglip-hf", default=None,
                        help="a local HF SiglipModel directory (read without network)")
    parser.add_argument("--siglip-tokenizer", default=None,
                        help="a local HF SiglipTokenizer directory (default: the byte-level fallback)")
    args = parser.parse_args(argv)
    if args.model_family == "siglip":
        if args.params_dtype == "auto":
            parser.error("--params-dtype auto is CLIP-only; use int8/bfloat16 explicitly for siglip")
        if args.checkpoint:
            parser.error("--checkpoint is CLIP-only: there is no SigLIP checkpoint format")
    return args


def main(argv=None):
    args = parse_args(argv)

    from werkzeug.serving import run_simple

    from evr_tpu_torch.ingest.annotators import build_annotator
    from evr_tpu_torch.models.quant_gate import auto_params_dtype
    from evr_tpu_torch.utils import get_logger

    from .app import create_app
    from .context import ServingContext

    log = get_logger("evr_tpu_torch.serving")
    mesh = None
    if args.shard_index:  # the index over every local card (and, for CLIP, the encodes)
        from evr_tpu_torch.parallel import get_mesh

        mesh = get_mesh(device=args.device)
        print(f"sharding over {mesh.shape} mesh", flush=True)
    engine = build_engine(args, mesh)
    transcriber = None
    if args.transcriber == "assemblyai":
        from .providers import AssemblyAITranscriber

        transcriber = AssemblyAITranscriber()
    annotator = build_annotator(engine, args.zeroshot_objects, args.local_ocr, device=args.device)
    ctx = ServingContext(
        args.data_root, engine=engine, index_dtype=args.index_dtype,
        search_impl=args.search_impl, ivf_nprobe=args.ivf_nprobe,
        ivf_clusters=args.ivf_clusters, ivfpq_host_store=args.ivfpq_host_store,
        batch_window_ms=args.batch_window_ms, transcriber=transcriber, mesh=mesh,
        annotator=annotator,
    )
    loaded = ctx.boot()
    if args.params_dtype == "auto":
        auto_params_dtype(engine, ctx.data_root, log=log)
    log.info(
        "serving %d videos (%d frames) from %s on %s:%d, device %s, %s weights",
        len(loaded), sum(i.total_frames for i in ctx._indexes.values()),
        args.data_root, args.host, args.port, engine.device, engine.params_dtype,
    )
    run_simple(args.host, args.port, create_app(ctx, frontend_dist=args.frontend_dist),
               threaded=True)


if __name__ == "__main__":
    main()
