"""Whisper on the port's serving path against the JAX package
(``tests/test_whisper.py``'s provider, route and CLI tests,
``tests/test_fallback_tokenizers.py``, ``tests/test_speech_search.py``'s
transcript loop): ``LocalWhisperTranscriber``, ``/api/transcribe-voice``,
``tools/transcribe.py`` (printed ids, ``--json``, the fallback text,
``--segments-out``) and a served root's speech search over the written
transcripts.

``WHISPER_SIZES["tiny-test"]`` on the CPU; the same weights in both
packages (JAX's params carried across, or one HF checkpoint file read by
both CLIs), spread so that every greedy step is far from a tie. Outputs
(ids, texts, transcript artifacts) equal.
"""

import io
import json
import wave

import numpy as np
import pytest
import torch

pytest.importorskip("werkzeug")

import jax
import jax.numpy as jnp

from evr_tpu.models import whisper as jw
from evr_tpu_torch.models import whisper as tw
from torch_threads import one_torch_thread  # noqa: F401

CFG_J, CFG_T = jw.WHISPER_SIZES["tiny-test"], tw.WHISPER_SIZES["tiny-test"]
SPREAD = dict(embed_scale=10.0, pos_scale=300.0)  # as tests/test_torch_whisper.py
LOGIT_TOL = 2e-4  # the fp32 logits' bound of tests/test_torch_whisper.py


def _far_from_ties(asr, audio, prompt=None):
    """Every greedy step of ``asr`` over ``audio`` (a WAV's path, or samples;
    each window) decides by a top-2 gap above 100 x LOGIT_TOL, so ids held
    equal to JAX's cannot flip near a tie unseen."""
    if not isinstance(audio, np.ndarray):
        audio = tw.read_wav(str(audio), asr.cfg.sampling_rate)
    windows = asr._windows(audio)
    mel = tw.log_mel_spectrogram(torch.from_numpy(windows), asr.filters, asr.cfg.n_fft, asr.cfg.hop_length)
    prompt = prompt or asr.prompt
    _, logits = tw.greedy_decode(asr.params, asr.cfg, mel, prompt, asr.max_len, return_logits=True)
    top2 = torch.topk(logits[:, len(prompt) - 1:], 2, dim=-1).values
    assert float((top2[..., 0] - top2[..., 1]).min()) > 100 * LOGIT_TOL


def _params(seed=7):
    p = jax.tree.map(np.array, jw.init_whisper_params(jax.random.PRNGKey(seed), CFG_J))
    p["decoder"]["token_embedding"] *= np.float32(SPREAD["embed_scale"])
    p["decoder"]["pos"] *= np.float32(SPREAD["pos_scale"])
    return p


def _asrs(params, **kw):
    return (jw.WhisperASR(jax.tree.map(jnp.asarray, params), CFG_J, prompt_ids=[CFG_J.sot_id], max_len=8, **kw),
            tw.WhisperASR(params, CFG_T, prompt_ids=[CFG_T.sot_id], max_len=8, device="cpu", **kw))


def _write_wav(path, rate=1600, seconds=2.0, freq=220.0):
    t = np.arange(int(rate * seconds)) / rate
    x = (0.3 * np.sin(2 * np.pi * freq * t) * 32767).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(x.tobytes())


def test_local_whisper_transcriber_matches_jax(tmp_path):
    """The provider constructs and transcribes: ids as text without a
    detokenizer, per-language prompts, then a detokenizer."""
    from evr_tpu.serving.providers import LocalWhisperTranscriber as J
    from evr_tpu_torch.serving.providers import LocalWhisperTranscriber as T

    jasr, tasr = _asrs(_params())
    _write_wav(tmp_path / "q.wav")
    prompts = {"vi": [CFG_T.sot_id, 4]}
    for prompt in ([CFG_T.sot_id], prompts["vi"]):
        _far_from_ties(tasr, tmp_path / "q.wav", prompt)
    jp, tp = J(jasr, language_prompts=prompts), T(tasr, language_prompts=prompts)
    for lang in ("en_us", "vi", "fr"):
        out = tp(str(tmp_path / "q.wav"), lang)
        assert isinstance(out, str) and out and out == jp(str(tmp_path / "q.wav"), lang), lang
    assert tp(str(tmp_path / "q.wav"), "vi") != tp(str(tmp_path / "q.wav"), "en_us")
    tasr.detokenize = lambda ids: "hello world"
    assert tp(str(tmp_path / "q.wav")) == "hello world"


def test_transcribe_route_with_local_provider_matches_jax(tmp_path):
    from werkzeug.test import Client

    from evr_tpu.index import EmbeddingEngine as JEngine
    from evr_tpu.serving import ServingContext as JContext, create_app as jcreate_app
    from evr_tpu.serving.providers import LocalWhisperTranscriber as J
    from evr_tpu_torch.index import EmbeddingEngine as TEngine
    from evr_tpu_torch.serving import ServingContext as TContext, create_app as tcreate_app
    from evr_tpu_torch.serving.providers import LocalWhisperTranscriber as T
    from torch_ingest_root import tiny_params

    clip = tiny_params(2)
    jasr, tasr = _asrs(_params(), detokenize="fallback")
    assert tasr.tokenizer_source == jasr.tokenizer_source == "fallback"
    apps = (Client(jcreate_app(JContext(str(tmp_path / "j"), engine=JEngine("ViT-Tiny-Test", params=clip),
                                        transcriber=J(jasr)))),
            Client(tcreate_app(TContext(str(tmp_path / "t"), engine=TEngine("ViT-Tiny-Test", params=clip,
                                                                              device="cpu"),
                                        transcriber=T(tasr)))))
    _write_wav(tmp_path / "v.wav", freq=330.0)
    _far_from_ties(tasr, tmp_path / "v.wav")
    bodies = []
    for c in apps:
        r = c.post("/api/transcribe-voice",
                   data={"audio": (io.BytesIO((tmp_path / "v.wav").read_bytes()), "v.wav"), "language": "vi"})
        assert r.status_code == 200, r.get_data(as_text=True)
        bodies.append(json.loads(r.get_data(as_text=True)))
    assert bodies[1]["text"] == bodies[0]["text"] and set(bodies[1]) == set(bodies[0])
    assert isinstance(bodies[1]["text"], str)


@pytest.fixture(scope="module")
def hf_checkpoint(tmp_path_factory):
    """A random-init HF Whisper of the tiny-test geometry, spread as
    ``_params`` spreads, saved as a state-dict file both CLIs read."""
    import transformers

    c = CFG_T
    torch.manual_seed(3)
    m = transformers.WhisperForConditionalGeneration(transformers.WhisperConfig(
        vocab_size=c.vocab_size, num_mel_bins=c.num_mel_bins, d_model=c.d_model,
        encoder_layers=c.encoder_layers, encoder_attention_heads=c.encoder_heads,
        decoder_layers=c.decoder_layers, decoder_attention_heads=c.decoder_heads,
        encoder_ffn_dim=c.ffn_dim, decoder_ffn_dim=c.ffn_dim, max_source_positions=c.max_source_positions,
        max_target_positions=c.max_target_positions, pad_token_id=0, bos_token_id=c.sot_id,
        eos_token_id=c.eos_id, decoder_start_token_id=c.sot_id))
    sd = {k: v.clone() for k, v in m.state_dict().items()}
    sd["model.decoder.embed_tokens.weight"] *= SPREAD["embed_scale"]
    sd["model.decoder.embed_positions.weight"] *= SPREAD["pos_scale"]
    path = tmp_path_factory.mktemp("hf") / "whisper.pt"
    torch.save(sd, path)
    return path


def _clis():
    from evr_tpu.tools import transcribe as jt
    from evr_tpu_torch.tools import transcribe as tt

    return jt.main, lambda argv: tt.main(argv + ["--device", "cpu"])


def test_transcribe_cli_matches_jax(tmp_path, hf_checkpoint, capsys):
    """Printed ids (``--raw-ids``), ``--json`` and the fallback text are the
    JAX CLI's on the same checkpoint; an unknown size or no weights exit."""
    wavs = [tmp_path / "a.wav", tmp_path / "b.wav"]
    _write_wav(wavs[0], freq=220.0)
    _write_wav(wavs[1], seconds=4.0, freq=500.0)
    base = [str(w) for w in wavs] + ["--size", "tiny-test", "--hf-checkpoint", str(hf_checkpoint), "--max-len", "8"]
    asr = tw.WhisperASR(tw.from_hf_whisper_state_dict(torch.load(hf_checkpoint), CFG_T), CFG_T, [CFG_T.sot_id],
                        max_len=8, device="cpu")
    for w in wavs:
        _far_from_ties(asr, w)
    outs = []
    for main in _clis():
        capsys.readouterr()
        raw = main(base + ["--raw-ids"])
        text = main(base)
        main(base + ["--json", "--raw-ids"])
        outs.append((raw, text, json.loads(capsys.readouterr().out.strip().splitlines()[-1])))
    (jraw, jtext, jjson), (traw, ttext, tjson) = outs
    assert traw == jraw and ttext == jtext and tjson == jjson
    assert all(isinstance(v, list) and v for v in traw.values())
    assert all(isinstance(v, str) for v in ttext.values())
    tmain = _clis()[1]
    for bad in (["--size", "nope", "--random-init"], []):
        with pytest.raises(SystemExit):
            tmain([str(wavs[0])] + bad)


def test_segments_out_feeds_speech_search(tmp_path, hf_checkpoint):
    """``--segments-out`` writes the JAX CLI's artifacts; a served root
    boots them, and a speech query through ``/api/search`` returns the
    transcribed video's frames inside the matching segment."""
    from werkzeug.test import Client

    from evr_tpu_torch.config import DataRootConfig
    from evr_tpu_torch.index import EmbeddingEngine, VideoRegistry
    from evr_tpu_torch.serving import ServingContext, create_app
    from torch_ingest_root import tiny_params

    root = DataRootConfig(tmp_path / "root").ensure()
    wav = tmp_path / "clipvid.wav"
    _write_wav(wav, seconds=5.0, freq=330.0)  # two 3 s windows
    argv = [str(wav), "--size", "tiny-test", "--hf-checkpoint", str(hf_checkpoint), "--max-len", "8", "--raw-ids"]
    written = []
    for main, out in zip(_clis(), (tmp_path / "jax", root.metadata_dir)):
        main(argv + ["--segments-out", str(out)])
        written.append(json.loads((out / "clipvid_transcript.json").read_text()))
    assert written[1] == written[0]
    segs = written[1]["segments"]
    assert [(s["start"], s["end"]) for s in segs] == [(0.0, 3.0), (3.0, 5.0)]

    frames = [{"frameidx": i, "frameid": f"{i}.jpg", "video": "videos/clipvid.mp4",
               "filepath": f"frames/clipvid/{i}.jpg", "tags": [], "metadata": {},
               "text_detections": {"detections": []}, "object_detections": {"detections": []}}
              for i in (10, 100)]  # 0.4 s and 4.0 s at 25 fps
    (root.metadata_dir / "clipvid_metadata.json").write_text(json.dumps(frames))
    np.save(root.embedding_dir / "clipvid_embeddings.npy", np.eye(2, 32, dtype=np.float32))
    (root.video_dir / "clipvid.mp4").write_bytes(b"")  # boot prunes entries whose video is gone
    VideoRegistry(root.mapping_path).add("clipvid", metadata_file="metadata/clipvid_metadata.json",
                                         embeddings_file="embedding/clipvid_embeddings.npy",
                                         video_path="videos/clipvid.mp4", frames_dir="frames/clipvid")
    ctx = ServingContext(root, engine=EmbeddingEngine("ViT-Tiny-Test", params=tiny_params(2), device="cpu"))
    assert ctx.boot() == ["clipvid"]
    needle = segs[1]["text"].split()[-1]
    r = Client(create_app(ctx)).post("/api/search", json={"search_method": "speech_only", "keyword": needle,
                                                          "query": needle, "top_k": 5})
    events = json.loads(r.get_data(as_text=True))["events"]
    assert events and {e["videoId"] for e in events} == {"video-clipvid"}
    assert any(needle in e["speech_text"] for e in events)
    assert {e["id"] for e in events} <= {"event-10", "event-100"}


def test_random_init_cli_and_fallback_asr(tmp_path):
    """``--random-init`` runs on the CPU and writes text segments through
    the fallback detokenizer; the fallback ASR's strings equal JAX's on
    carried params (``tests/test_fallback_tokenizers.py``'s loop)."""
    from evr_tpu_torch.tools import transcribe

    wav = tmp_path / "r.wav"
    _write_wav(wav)
    out = transcribe.main([str(wav), "--random-init", "--size", "tiny-test", "--max-len", "8", "--device", "cpu",
                           "--segments-out", str(tmp_path / "meta")])
    payload = json.loads((tmp_path / "meta" / "r_transcript.json").read_text())
    assert payload == out[str(wav)] and payload["video"] == "r"
    assert all(isinstance(s["text"], str) and s["text"] for s in payload["segments"])
    jasr, tasr = _asrs(_params(), detokenize="fallback")
    audio = np.sin(np.linspace(0, 440 * 2 * np.pi, 16000)).astype(np.float32)
    _far_from_ties(tasr, audio)
    assert tasr.transcribe(audio) == jasr.transcribe(audio)
    assert tasr.transcribe_segments(audio) == jasr.transcribe_segments(audio)
