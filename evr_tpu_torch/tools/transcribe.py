"""Whisper transcription CLI on the card (the voice-search pillar, offline).

Counterpart of the JAX package's ``tools/transcribe.py``; the reference's
route ships each recording to AssemblyAI over the network
(`Backend/app.py:766-850`). WAV in, a transcript (or raw token ids) out,
through ``models.whisper``::

    python -m evr_tpu_torch.tools.transcribe a.wav --size large-v3 \\
        --hf-checkpoint whisper.pt [--tokenizer-dir tok/] [--device cuda|cpu]

Weights are a deployment asset: ``--hf-checkpoint`` is a torch state-dict
file of an HF Whisper model (any ``openai/whisper-*``), read with its
``--size``; ``--random-init`` draws seeded random weights for a smoke run.
With ``--tokenizer-dir`` (HF WhisperTokenizer files) the output is text in
the real vocabulary; otherwise the byte-level fallback detokenizer
(``tokenizer.fallbacks.WhisperFallbackTokenizer``, not the real vocabulary)
keeps the output textual, and ``--raw-ids`` prints the ids instead.
``--segments-out DIR`` writes ``{video}_transcript.json`` artifacts (the
video name is the WAV's stem) that a served data root's boot loads for
speech search. ``--device`` (default cuda) runs on the CPU on request.
"""

from __future__ import annotations

import argparse
import json


def _load_detokenizer(tokenizer_dir: str):
    from transformers import WhisperTokenizer

    tok = WhisperTokenizer.from_pretrained(tokenizer_dir, local_files_only=True)
    return lambda ids: tok.decode(ids, skip_special_tokens=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Whisper transcription on the card")
    parser.add_argument("audio", nargs="+", help="PCM WAV file(s)")
    parser.add_argument("--size", default="tiny", help="Whisper geometry name")
    parser.add_argument("--hf-checkpoint", default=None, help="torch state-dict file of an HF Whisper model")
    parser.add_argument("--random-init", action="store_true",
                        help="seeded random weights (a smoke run of the compute path)")
    parser.add_argument("--tokenizer-dir", default=None, help="HF WhisperTokenizer files (real-vocabulary text)")
    parser.add_argument("--raw-ids", action="store_true",
                        help="print raw token ids instead of the byte-level fallback's text")
    parser.add_argument("--prompt-ids", type=int, nargs="+", default=None,
                        help="forced header token ids (default: [sot])")
    parser.add_argument("--max-len", type=int, default=224)
    parser.add_argument("--json", action="store_true", dest="as_json")
    parser.add_argument(
        "--segments-out", default=None, metavar="DIR",
        help="write searchable transcript artifacts ({video}_transcript.json) into DIR instead of "
        "printing text; the video name is the WAV's stem. Point DIR at a data root's metadata "
        "directory and its boot loads them for speech search",
    )
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; fails without a card unless cpu is given)")
    args = parser.parse_args(argv)

    from evr_tpu_torch.models.whisper import (
        WHISPER_SIZES,
        WhisperASR,
        from_hf_whisper_state_dict,
        init_whisper_params,
        read_wav,
    )
    from evr_tpu_torch.utils.device import resolve_device

    if args.size not in WHISPER_SIZES:
        raise SystemExit(f"unknown --size {args.size!r}; choose from {sorted(WHISPER_SIZES)}")
    cfg = WHISPER_SIZES[args.size]
    device = resolve_device(args.device)

    if args.hf_checkpoint:
        import torch

        sd = torch.load(args.hf_checkpoint, map_location="cpu", weights_only=True)
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
        params = from_hf_whisper_state_dict(sd, cfg)
    elif args.random_init:
        params = init_whisper_params(0, cfg, device)
    else:
        raise SystemExit("need --hf-checkpoint (or --random-init for a smoke run)")

    if args.tokenizer_dir:
        detok = _load_detokenizer(args.tokenizer_dir)
    elif args.raw_ids:
        detok = None
    else:
        detok = "fallback"  # the zero-egress default: not the real vocabulary
    prompt = args.prompt_ids if args.prompt_ids is not None else [cfg.sot_id]
    asr = WhisperASR(params, cfg, prompt_ids=prompt, max_len=args.max_len, detokenize=detok, device=device)

    if args.segments_out:
        import pathlib

        from evr_tpu_torch.ingest.transcripts import WhisperSegmentTranscriber, build_video_transcript

        out_dir = pathlib.Path(args.segments_out)
        transcriber = WhisperSegmentTranscriber(asr, prompt_ids=args.prompt_ids)
        results = {}
        for path in args.audio:
            name = pathlib.Path(path).stem
            out_path = out_dir / f"{name}_transcript.json"
            payload = build_video_transcript(path, name, transcriber, out_path, cfg.sampling_rate)
            results[path] = payload
            print(f"wrote {out_path} ({len(payload['segments'])} segments)")
        return results

    results = {}
    for path in args.audio:
        (out,) = asr.transcribe(read_wav(path, cfg.sampling_rate))
        results[path] = out
        if not args.as_json:
            print(f"{path}: {out}")
    if args.as_json:
        print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
