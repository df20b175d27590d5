"""The port's Whisper against the JAX package (``tests/test_whisper.py``):
the log-mel frontend, the towers, the HF converter, the KV-cached greedy
decode (ids, eos hold, suppression, the full re-run oracle), the ASR
wrapper and the host-side audio helpers.

JAX's tiny geometry (and ``WHISPER_SIZES["tiny-test"]``), its params
carried across, both on the CPU in fp32. Tolerances: the log-mel atol 1e-5;
encoder states and teacher-forced logits atol 2e-4 (``LOGIT_TOL``, the
port's fp32 tower bound); token ids equal, where every free step's top-2
gap exceeds 100 × ``LOGIT_TOL`` (asserted, so a flip near a tie cannot pass
unseen).
"""

import dataclasses
import wave

import numpy as np
import torch

import jax
import jax.numpy as jnp

from evr_tpu.models import whisper as jw
from evr_tpu_torch.models import whisper as tw
from evr_tpu_torch.models.convert import params_from_numpy
from torch_threads import one_torch_thread  # noqa: F401

LOGIT_TOL = 2e-4
MEL_TOL = 1e-5
TINY = dict(vocab_size=128, num_mel_bins=8, d_model=32, encoder_layers=2, encoder_heads=2, decoder_layers=2,
            decoder_heads=2, ffn_dim=64, max_source_positions=24, max_target_positions=16, eos_id=2, sot_id=1)
JT, TT = jw.WhisperConfig(**TINY), tw.WhisperConfig(**TINY)


def _params(seed, embed_scale=1.0, pos_scale=1.0):
    """JAX's random init carried across. ``embed_scale`` widens the token
    embedding (and so the logits' spread) and ``pos_scale`` the decoder's
    positions (so each step's row differs from the last), for decodes of
    varied ids whose argmax is far from ties."""
    p = jax.tree.map(np.array, jw.init_whisper_params(jax.random.PRNGKey(seed), JT))
    p["decoder"]["token_embedding"] *= np.float32(embed_scale)
    p["decoder"]["pos"] *= np.float32(pos_scale)
    return p, params_from_numpy(p)


SPREAD = dict(embed_scale=10.0, pos_scale=300.0)


def _mel(seed, b=2):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, TINY["num_mel_bins"], 2 * TINY["max_source_positions"])).astype(np.float32)


def test_mel_filter_bank_and_log_mel_match_jax_and_hf():
    import transformers
    from transformers import audio_utils

    fb = tw.mel_filter_bank(201, 80, 16000)
    np.testing.assert_array_equal(fb, jw.mel_filter_bank(201, 80, 16000))
    hf = audio_utils.mel_filter_bank(num_frequency_bins=201, num_mel_filters=80, min_frequency=0.0,
                                     max_frequency=8000.0, sampling_rate=16000, norm="slaney", mel_scale="slaney")
    np.testing.assert_allclose(fb, hf.T, atol=1e-7)
    audio = np.random.default_rng(0).standard_normal((2, 32000)).astype(np.float32) * 0.1
    ref = np.asarray(jw.log_mel_spectrogram(jnp.asarray(audio), jnp.asarray(fb), 400, 160))
    got = tw.log_mel_spectrogram(torch.from_numpy(audio), torch.from_numpy(fb), 400, 160).numpy()
    assert got.shape == ref.shape == (2, 80, 200)  # S // hop frames: the last one dropped
    np.testing.assert_allclose(got, ref, rtol=0, atol=MEL_TOL)
    fe = transformers.WhisperFeatureExtractor(feature_size=80, n_fft=400, hop_length=160, chunk_length=2)
    theirs = fe(audio[0], sampling_rate=16000, return_tensors="np").input_features
    np.testing.assert_allclose(got[:1], theirs, atol=2e-4)
    # the clamp is per example: a quiet row keeps its own floor
    loud = np.concatenate([audio[:1] * 100.0, audio[1:]])
    both = tw.log_mel_spectrogram(torch.from_numpy(loud), torch.from_numpy(fb), 400, 160).numpy()
    np.testing.assert_allclose(both[1], got[1], rtol=0, atol=MEL_TOL)


def test_towers_match_jax():
    jp, tp = _params(0)
    mel = _mel(1)
    enc = np.array(jw.encoder_forward(jax.tree.map(jnp.asarray, jp), JT, jnp.asarray(mel)))
    got = tw.encoder_forward(tp, TT, torch.from_numpy(mel)).numpy()
    assert got.shape == (2, TINY["max_source_positions"], TINY["d_model"])
    np.testing.assert_allclose(got, enc, rtol=0, atol=LOGIT_TOL)
    tokens = np.random.default_rng(1).integers(3, TINY["vocab_size"], (2, 7))
    ref = np.asarray(jw.decoder_forward(jax.tree.map(jnp.asarray, jp), JT, jnp.asarray(tokens.astype(np.int32)),
                                        jnp.asarray(enc)))
    got = tw.decoder_forward(tp, TT, torch.from_numpy(tokens), torch.from_numpy(enc)).numpy()
    assert got.dtype == np.float32 and got.shape == (2, 7, TINY["vocab_size"])
    np.testing.assert_allclose(got, ref, rtol=0, atol=LOGIT_TOL)


def test_hf_random_init_through_both_converters():
    import transformers

    hf_cfg = transformers.WhisperConfig(
        vocab_size=TINY["vocab_size"], num_mel_bins=TINY["num_mel_bins"], d_model=TINY["d_model"],
        encoder_layers=2, encoder_attention_heads=2, decoder_layers=2, decoder_attention_heads=2,
        encoder_ffn_dim=64, decoder_ffn_dim=64, max_source_positions=24, max_target_positions=16,
        pad_token_id=0, bos_token_id=1, eos_token_id=2, decoder_start_token_id=1)
    torch.manual_seed(0)
    m = transformers.WhisperForConditionalGeneration(hf_cfg).eval()
    tnp = tw.from_hf_whisper_state_dict(m.state_dict(), TT)
    jnp_ = jw.from_hf_whisper_state_dict({k: v.numpy() for k, v in m.state_dict().items()}, JT)
    jl, jdef = jax.tree_util.tree_flatten(jnp_)
    tl, tdef = jax.tree_util.tree_flatten(tnp)
    assert jdef == tdef and "bias" not in tnp["encoder"]["blocks"][0]["attn"]["k"]
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(b, np.asarray(a))
    tp = params_from_numpy(tnp)
    mel, tokens = _mel(2), np.random.default_rng(2).integers(3, TINY["vocab_size"], (2, 7))
    with torch.no_grad():
        out = m(input_features=torch.from_numpy(mel), decoder_input_ids=torch.from_numpy(tokens))
    enc = tw.encoder_forward(tp, TT, torch.from_numpy(mel))
    np.testing.assert_allclose(enc.numpy(), out.encoder_last_hidden_state.numpy(), atol=LOGIT_TOL)
    logits = tw.decoder_forward(tp, TT, torch.from_numpy(tokens), enc)
    np.testing.assert_allclose(logits.numpy(), out.logits.numpy(), atol=5e-4)


def test_greedy_decode_matches_jax_far_from_ties():
    jp, tp = _params(1, **SPREAD)
    mel, prompt, max_len = _mel(2), [1, 5, 9], 12
    ref = np.asarray(jw.greedy_decode(jax.tree.map(jnp.asarray, jp), JT, jnp.asarray(mel), jnp.asarray(prompt),
                                      max_len))
    ids, logits = tw.greedy_decode(tp, TT, torch.from_numpy(mel), prompt, max_len, return_logits=True)
    top2 = torch.topk(logits[:, len(prompt) - 1:], 2, dim=-1).values
    assert float((top2[..., 0] - top2[..., 1]).min()) > 100 * LOGIT_TOL
    np.testing.assert_array_equal(ids.numpy(), ref)
    assert len(set(ids[:, len(prompt):].reshape(-1).tolist())) > 1  # not one repeated id
    # each step's logits are the teacher-forced decoder's last row on the ids so far
    enc = tw.encoder_forward(tp, TT, torch.from_numpy(mel))
    forced = tw.decoder_forward(tp, TT, ids[:, :-1], enc)
    np.testing.assert_allclose(logits.numpy(), forced.numpy(), rtol=0, atol=LOGIT_TOL)


def _oracle(params, cfg, mel, prompt, max_len):
    """The full re-run greedy decode (the teacher-forced decoder each step)."""
    enc = tw.encoder_forward(params, cfg, torch.from_numpy(mel))
    seq = torch.full((mel.shape[0], 1), prompt[0], dtype=torch.long)
    done = torch.zeros(mel.shape[0], dtype=torch.bool)
    for t in range(max_len - 1):
        nxt = tw.decoder_forward(params, cfg, seq, enc)[:, -1].argmax(-1)
        if t + 1 < len(prompt):
            nxt = torch.full_like(nxt, prompt[t + 1])
        nxt = torch.where(done, torch.full_like(nxt, cfg.eos_id), nxt)
        done = done | (nxt == cfg.eos_id)
        seq = torch.cat([seq, nxt[:, None]], dim=1)
    return seq


def test_greedy_decode_matches_full_rerun_oracle():
    _, tp = _params(1, **SPREAD)
    mel, prompt = _mel(3), [1, 5, 9]
    fast = tw.greedy_decode(tp, TT, torch.from_numpy(mel), prompt, 12)
    np.testing.assert_array_equal(fast.numpy(), _oracle(tp, TT, mel, prompt, 12).numpy())
    np.testing.assert_array_equal(fast[:, :3].numpy(), np.tile(prompt, (2, 1)))


def test_eos_hold_and_suppress_mask_match_jax():
    """eos is id 109 here, which the free decode emits at position 3 (and
    would follow by 126, 67, ...): every later position holds it; and a
    suppression mask keeping ids 0..2 only."""
    jp, tp = _params(10, **SPREAD)
    mel = _mel(4, b=3)
    free, logits = tw.greedy_decode(tp, TT, torch.from_numpy(mel), [1], 10, return_logits=True)
    top2 = torch.topk(logits, 2, dim=-1).values
    assert float((top2[..., 0] - top2[..., 1]).min()) > 100 * LOGIT_TOL
    assert free[:, 3].tolist() == [109] * 3 and (free[:, 4:] != 109).any()
    jc, tc = dataclasses.replace(JT, eos_id=109), dataclasses.replace(TT, eos_id=109)
    ref = np.asarray(jw.greedy_decode(jax.tree.map(jnp.asarray, jp), jc, jnp.asarray(mel), jnp.asarray([1]), 10))
    got = tw.greedy_decode(tp, tc, torch.from_numpy(mel), [1], 10)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got[:, :4].numpy(), free[:, :4].numpy())
    assert (got[:, 3:] == 109).all()
    mask = np.zeros(TINY["vocab_size"], bool)
    mask[3:] = True  # only ids 0..2 allowed
    ref = np.asarray(jw.greedy_decode(jax.tree.map(jnp.asarray, jp), JT, jnp.asarray(mel), jnp.asarray([1]), 8,
                                      suppress_mask=jnp.asarray(mask)))
    got = tw.greedy_decode(tp, TT, torch.from_numpy(mel), [1], 8, suppress_mask=torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert (got[:, 1:] < 3).all()


def _assert_far_from_ties(asr, audio, prompt):
    """Every free greedy step of ``asr`` over ``audio``'s windows decides by
    a top-2 gap above 100 x LOGIT_TOL."""
    mel = tw.log_mel_spectrogram(torch.from_numpy(asr._windows(audio)), asr.filters, asr.cfg.n_fft,
                                 asr.cfg.hop_length)
    _, logits = tw.greedy_decode(asr.params, asr.cfg, mel, prompt, asr.max_len, return_logits=True)
    top2 = torch.topk(logits[:, len(prompt) - 1:], 2, dim=-1).values
    assert float((top2[..., 0] - top2[..., 1]).min()) > 100 * LOGIT_TOL


def test_whisper_asr_matches_jax():
    """``transcribe`` (ids, then a detokenizer), ``transcribe_long`` over
    2.5 windows, ``transcribe_segments`` and the ``max_len`` clamp; every
    decode far from ties."""
    cfg_j, cfg_t = jw.WHISPER_SIZES["tiny-test"], tw.WHISPER_SIZES["tiny-test"]
    assert vars(cfg_t) == vars(cfg_j)
    jp = jax.tree.map(np.array, jw.init_whisper_params(jax.random.PRNGKey(12), cfg_j))
    jp["decoder"]["token_embedding"] *= np.float32(SPREAD["embed_scale"])
    jp["decoder"]["pos"] *= np.float32(SPREAD["pos_scale"])
    jasr = jw.WhisperASR(jax.tree.map(jnp.asarray, jp), cfg_j, prompt_ids=[cfg_j.sot_id], max_len=8)
    tasr = tw.WhisperASR(jp, cfg_t, prompt_ids=[cfg_t.sot_id], max_len=8, device="cpu")
    assert tasr.tokenizer_source == jasr.tokenizer_source == "none"
    audio = np.random.default_rng(10).standard_normal(int(2.5 * cfg_t.n_samples)).astype(np.float32)
    for clip, prompt in ((audio[:4000], [1]), (audio[:4000], [1, 4]), (audio, [1])):
        _assert_far_from_ties(tasr, clip, prompt)
    assert tasr.transcribe(audio[:4000]) == jasr.transcribe(audio[:4000])
    assert tasr.transcribe(audio[:4000], prompt_ids=[1, 4]) == jasr.transcribe(audio[:4000], prompt_ids=[1, 4])
    assert tasr.transcribe_long(audio) == jasr.transcribe_long(audio)
    assert tasr.transcribe_segments(audio) == jasr.transcribe_segments(audio)
    per_window = [t for i in range(3)
                  for t in tasr.transcribe(audio[i * cfg_t.n_samples:(i + 1) * cfg_t.n_samples])[0]]
    assert tasr.transcribe_long(audio) == per_window
    for asr in (jasr, tasr):
        asr.detokenize = lambda ids: f"<{len(ids)}>"
    assert tasr.transcribe_long(audio) == jasr.transcribe_long(audio)
    assert tasr.transcribe_segments(audio) == jasr.transcribe_segments(audio)
    assert tw.WhisperASR(jp, cfg_t, [1], max_len=500, device="cpu").max_len == cfg_t.max_target_positions


def test_audio_helpers_sizes_and_init(tmp_path):
    rate = 8000
    x = (0.5 * np.sin(2 * np.pi * 440 * np.arange(rate) / rate)).astype(np.float32)
    path = tmp_path / "a.wav"
    with wave.open(str(path), "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(np.repeat((x * 32767).astype(np.int16), 2).tobytes())
    np.testing.assert_array_equal(tw.read_wav(str(path), 16000), jw.read_wav(str(path), 16000))
    for n in (3, 8):
        np.testing.assert_array_equal(tw.pad_or_trim(np.ones((2, 5), np.float32), n),
                                      jw.pad_or_trim(np.ones((2, 5), np.float32), n))
    np.testing.assert_array_equal(tw.sinusoids(24, 32), jw.sinusoids(24, 32))
    assert set(tw.WHISPER_SIZES) == set(jw.WHISPER_SIZES)
    for name, cfg in jw.WHISPER_SIZES.items():
        assert vars(tw.WHISPER_SIZES[name]) == vars(cfg), name
    cfg = dataclasses.replace(TT, vocab_size=40)
    p = tw.init_whisper_params(0, cfg, device="cpu")
    shapes = jax.tree.map(lambda a: tuple(a.shape), p)
    assert shapes == jax.tree.map(lambda a: a.shape, jw.init_whisper_params(jax.random.PRNGKey(0),
                                                                            dataclasses.replace(JT, vocab_size=40)))
    np.testing.assert_array_equal(p["encoder"]["pos"].numpy(), jw.sinusoids(24, 32))
    assert torch.equal(p["decoder"]["pos"], tw.init_whisper_params(0, cfg, device="cpu")["decoder"]["pos"])
