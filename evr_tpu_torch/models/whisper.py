"""Whisper speech recognition in PyTorch (voice search on the card).

Counterpart of the JAX package's ``models/whisper.py``, and the zero-egress
replacement of the reference's voice route, which ships every recording to
AssemblyAI over the network (`Backend/app.py:766-850`). The same
configurations, params layout (linear kernels ``[in, out]``, the conv1d
kernels OIH, k without a bias) and functions:

- ``log_mel_spectrogram``: reflect pad by n_fft/2, frames by gather
  (S // hop of them: the last is dropped), a periodic Hann window in fp32,
  ``torch.fft.rfft``, |·|², the slaney mel filters (``mel_filter_bank``,
  numpy, built once), the 1e-10 floor, log10, the per-example max − 8 clamp
  over (mel, frames), (x + 4) / 4: HF ``WhisperFeatureExtractor``'s numerics;
- ``encoder_forward`` / ``decoder_forward``: pre-LN blocks with exact (erf)
  GELU, separate q/k/v projections, the stride-2 conv1d stem (padding 1
  both sides), sinusoidal encoder positions, learned decoder positions, the
  output tied to the token embedding;
- ``greedy_decode``: per-layer self-attention K/V caches written row by
  row, cross-attention K/V projected once from the encoder states, the
  forced prompt emitted positionally, eos held once emitted,
  ``suppress_mask`` at −1e9; a Python loop over positions;
- ``from_hf_whisper_state_dict`` (any HF Whisper checkpoint), ``read_wav``
  and ``WhisperASR`` (``transcribe``, ``transcribe_long``,
  ``transcribe_segments``).

The blocks are this module's own plain composition (no kernel of ``ops``):
attention is the JAX package's einsums, the scores cast to fp32 for the
softmax and the weights cast back. The compute dtype is an argument;
``init_whisper_params`` draws from a seeded ``torch.Generator`` on the
target device (tests carry the JAX package's params across with
``models.convert.params_from_numpy``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F

from evr_tpu_torch.utils.device import resolve_device

from .layers import layer_norm, linear
from .siglip import rounded

Params = dict[str, Any]


@dataclass(frozen=True)
class WhisperConfig:
    """Geometry of one Whisper variant (field names follow HF WhisperConfig)."""

    vocab_size: int = 51865
    num_mel_bins: int = 80
    d_model: int = 384
    encoder_layers: int = 4
    encoder_heads: int = 6
    decoder_layers: int = 4
    decoder_heads: int = 6
    ffn_dim: int = 1536  # the same for encoder and decoder in every published size
    max_source_positions: int = 1500  # after the stride-2 conv: 30 s / 20 ms
    max_target_positions: int = 448
    # the audio frontend (fixed across the published sizes)
    sampling_rate: int = 16000
    n_fft: int = 400
    hop_length: int = 160
    chunk_length: int = 30  # seconds a window
    # special token ids (multilingual layout; -1 disables the eos stop)
    eos_id: int = 50257
    sot_id: int = 50258

    @property
    def n_samples(self) -> int:
        return self.chunk_length * self.sampling_rate

    @property
    def n_frames(self) -> int:
        return self.n_samples // self.hop_length


#: Published Whisper geometries (vocab 51865 = the multilingual v1/v2 layout;
#: large-v3 has 51866 and 128 mel bins) and a CPU-sized "tiny-test".
WHISPER_SIZES: dict[str, WhisperConfig] = {
    "tiny": WhisperConfig(d_model=384, encoder_layers=4, decoder_layers=4,
                          encoder_heads=6, decoder_heads=6, ffn_dim=1536),
    "base": WhisperConfig(d_model=512, encoder_layers=6, decoder_layers=6,
                          encoder_heads=8, decoder_heads=8, ffn_dim=2048),
    "small": WhisperConfig(d_model=768, encoder_layers=12, decoder_layers=12,
                           encoder_heads=12, decoder_heads=12, ffn_dim=3072),
    "medium": WhisperConfig(d_model=1024, encoder_layers=24, decoder_layers=24,
                            encoder_heads=16, decoder_heads=16, ffn_dim=4096),
    "large-v2": WhisperConfig(d_model=1280, encoder_layers=32, decoder_layers=32,
                              encoder_heads=20, decoder_heads=20, ffn_dim=5120),
    "large-v3": WhisperConfig(vocab_size=51866, num_mel_bins=128, d_model=1280,
                              encoder_layers=32, decoder_layers=32,
                              encoder_heads=20, decoder_heads=20, ffn_dim=5120,
                              eos_id=50257, sot_id=50258),
    "tiny-test": WhisperConfig(vocab_size=128, num_mel_bins=8, d_model=32,
                               encoder_layers=2, decoder_layers=2,
                               encoder_heads=2, decoder_heads=2, ffn_dim=64,
                               max_source_positions=24, max_target_positions=16,
                               sampling_rate=1600, n_fft=64, hop_length=100,
                               chunk_length=3, eos_id=2, sot_id=1),
}


# -- the log-mel frontend -----------------------------------------------------


def _hz_to_mel_slaney(f) -> np.ndarray:
    """Slaney mel scale: linear below 1 kHz, log above (librosa htk=False)."""
    f = np.asarray(f, dtype=np.float64)
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / (200.0 / 3)
    logstep = math.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(np.maximum(f, min_log_hz) / min_log_hz) / logstep,
                    f / (200.0 / 3))


def _mel_to_hz_slaney(m) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / (200.0 / 3)
    logstep = math.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), m * (200.0 / 3))


def mel_filter_bank(n_freqs: int, n_mels: int, sampling_rate: int, min_frequency: float = 0.0,
                    max_frequency: float = 8000.0) -> np.ndarray:
    """[n_mels, n_freqs] slaney-scale, slaney-normalised triangular filters
    (librosa ``filters.mel(htk=False, norm='slaney')``, HF
    ``audio_utils.mel_filter_bank(mel_scale='slaney', norm='slaney')``)."""
    fft_freqs = np.linspace(0.0, sampling_rate / 2.0, n_freqs)
    mel_pts = np.linspace(_hz_to_mel_slaney(np.array(min_frequency)),
                          _hz_to_mel_slaney(np.array(max_frequency)), n_mels + 2)
    hz_pts = _mel_to_hz_slaney(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    fb = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2:n_mels + 2] - hz_pts[:n_mels])
    return (fb * enorm[:, None]).astype(np.float32)


def log_mel_spectrogram(audio: torch.Tensor, filters: torch.Tensor, n_fft: int,
                        hop_length: int) -> torch.Tensor:
    """[B, S] waveform → [B, n_mels, S // hop] Whisper log-mel features in
    float32, on the waveform's device."""
    audio = torch.as_tensor(audio).float()
    B, S = audio.shape
    pad = n_fft // 2
    x = F.pad(audio[:, None], (pad, pad), mode="reflect")[:, 0]
    n_frames = S // hop_length  # center=True gives 1 + S // hop; the last is dropped
    dev = x.device
    idx = torch.arange(n_frames, device=dev)[:, None] * hop_length + torch.arange(n_fft, device=dev)[None, :]
    frames = x[:, idx]  # [B, F, n_fft]
    window = 0.5 * (1.0 - torch.cos(2.0 * math.pi * torch.arange(n_fft, device=dev, dtype=torch.float32) / n_fft))
    power = torch.fft.rfft(frames * window, n=n_fft, dim=-1).abs() ** 2  # [B, F, n_freqs]
    mel = torch.einsum("bfk,mk->bmf", power, filters.float().to(dev))
    log_spec = torch.log10(torch.clamp_min(mel, 1e-10))
    log_spec = torch.maximum(log_spec, log_spec.amax(dim=(1, 2), keepdim=True) - 8.0)
    return (log_spec + 4.0) / 4.0


def pad_or_trim(audio: np.ndarray, n_samples: int) -> np.ndarray:
    """Whisper's fixed window: the waveform zero-padded or cut to ``n_samples``."""
    if audio.shape[-1] >= n_samples:
        return audio[..., :n_samples]
    pad = n_samples - audio.shape[-1]
    return np.pad(audio, [(0, 0)] * (audio.ndim - 1) + [(0, pad)])


def sinusoids(length: int, channels: int) -> np.ndarray:
    """Whisper's fixed sinusoidal positions: [sin | cos] concatenated."""
    log_timescale = math.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32)


# -- parameters -----------------------------------------------------------------


def init_whisper_params(seed: int, cfg: WhisperConfig, device=None) -> Params:
    """Random Whisper weights at the JAX package's init scales in the
    published layout, float32 tensors on ``device`` (None: the card), drawn
    from a ``torch.Generator`` seeded with ``seed`` on that device."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    W = cfg.d_model

    def normal(shape, std):
        return torch.randn(shape, generator=gen, device=dev) * std

    def ln():
        return {"scale": torch.ones(W, device=dev), "bias": torch.zeros(W, device=dev)}

    def lin(d_in, d_out, bias=True):
        p = {"kernel": normal((d_in, d_out), d_in ** -0.5)}
        if bias:
            p["bias"] = torch.zeros(d_out, device=dev)
        return p

    def mha():  # Whisper's k_proj has no bias
        return {"q": lin(W, W), "k": lin(W, W, bias=False), "v": lin(W, W), "out": lin(W, W)}

    def mlp():
        return {"fc1": lin(W, cfg.ffn_dim), "fc2": lin(cfg.ffn_dim, W)}

    enc_blocks = [{"ln1": ln(), "attn": mha(), "ln2": ln(), "mlp": mlp()} for _ in range(cfg.encoder_layers)]
    dec_blocks = [{"ln1": ln(), "attn": mha(), "ln_x": ln(), "xattn": mha(), "ln2": ln(), "mlp": mlp()}
                  for _ in range(cfg.decoder_layers)]
    return {
        "encoder": {
            "conv1": {"kernel": normal((W, cfg.num_mel_bins, 3), (cfg.num_mel_bins * 3) ** -0.5),
                      "bias": torch.zeros(W, device=dev)},
            "conv2": {"kernel": normal((W, W, 3), (W * 3) ** -0.5), "bias": torch.zeros(W, device=dev)},
            "pos": torch.from_numpy(sinusoids(cfg.max_source_positions, W)).to(dev),
            "blocks": enc_blocks,
            "ln_post": ln(),
        },
        "decoder": {
            "token_embedding": normal((cfg.vocab_size, W), 0.02),
            "pos": normal((cfg.max_target_positions, W), 0.01),
            "blocks": dec_blocks,
            "ln_post": ln(),
        },
    }


# -- forward ----------------------------------------------------------------------


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")  # Whisper's exact GELU (SigLIP's is tanh)


def _heads(t: torch.Tensor, n_heads: int) -> torch.Tensor:
    B, T, W = t.shape
    return t.reshape(B, T, n_heads, W // n_heads).transpose(1, 2)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask=None) -> torch.Tensor:
    """q [B, H, Tq, d], k/v [B, H, Tk, d] → [B, Tq, H·d]: scores in the
    dtype cast to fp32, masked to −1e9, fp32 softmax cast back."""
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k).float()
    if mask is not None:
        logits = logits.masked_fill(~mask, -1e9)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    o = torch.einsum("bhqk,bhkd->bhqd", w, v)
    B, H, Tq, d = o.shape
    return o.transpose(1, 2).reshape(B, Tq, H * d)


def _q(x: torch.Tensor, p: Params, n_heads: int) -> torch.Tensor:
    """The pre-scaled query projection: ``linear(x, q) · d^-0.5`` with the
    factor rounded to the dtype, as the JAX package's constant is."""
    hd = x.shape[-1] // n_heads
    return linear(x, p["q"]) * rounded(hd ** -0.5, x.dtype)


def _mha(x_q: torch.Tensor, x_kv: torch.Tensor, p: Params, n_heads: int, causal: bool = False) -> torch.Tensor:
    """Separate-projection multi-head attention (HF Whisper: q pre-scaled,
    fp32 softmax, k without a bias)."""
    Tq, Tk = x_q.shape[1], x_kv.shape[1]
    q = _heads(_q(x_q, p, n_heads), n_heads)
    k = _heads(linear(x_kv, p["k"]), n_heads)
    v = _heads(linear(x_kv, p["v"]), n_heads)
    mask = None
    if causal:
        mask = torch.ones(Tq, Tk, dtype=torch.bool, device=x_q.device).tril(Tk - Tq)
    return linear(_attend(q, k, v, mask), p["out"])


def _mlp(x: torch.Tensor, p: Params) -> torch.Tensor:
    return linear(_gelu(linear(x, p["fc1"])), p["fc2"])


def _conv1d(x: torch.Tensor, p: Params, stride: int, dtype) -> torch.Tensor:
    """conv1d with OIH kernels, padding 1 on both sides; the bias added in
    the dtype after the product."""
    y = F.conv1d(x, p["kernel"].to(dtype), stride=stride, padding=1)
    return y + p["bias"].to(dtype)[None, :, None]


def encoder_forward(params: Params, cfg: WhisperConfig, mel: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """[B, n_mels, F] log-mel → [B, F // 2, d_model] audio states."""
    enc = params["encoder"]
    x = torch.as_tensor(mel).to(enc["pos"].device, dtype)
    x = _gelu(_conv1d(x, enc["conv1"], 1, dtype))
    x = _gelu(_conv1d(x, enc["conv2"], 2, dtype))
    x = x.transpose(1, 2)  # [B, T, D]
    x = x + enc["pos"][: x.shape[1]].to(dtype)
    for blk in enc["blocks"]:
        h = layer_norm(x, blk["ln1"])
        x = x + _mha(h, h, blk["attn"], cfg.encoder_heads)
        x = x + _mlp(layer_norm(x, blk["ln2"]), blk["mlp"])
    return layer_norm(x, enc["ln_post"])


def _logits(x: torch.Tensor, dec: Params) -> torch.Tensor:
    """Final LN'd rows → fp32 logits over the tied token embedding."""
    return (x @ dec["token_embedding"].to(x.dtype).T).float()


def decoder_forward(params: Params, cfg: WhisperConfig, tokens: torch.Tensor, enc_states: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    """Teacher-forced decoder: [B, L] tokens → [B, L, vocab] fp32 logits (the
    full-sequence path: the oracle of ``greedy_decode``)."""
    dec = params["decoder"]
    dev = dec["pos"].device
    tokens = torch.as_tensor(tokens).long().to(dev)
    L = tokens.shape[1]
    x = dec["token_embedding"][tokens].to(dtype) + dec["pos"][:L].to(dtype)
    enc_states = enc_states.to(dev, dtype)
    for blk in dec["blocks"]:
        h = layer_norm(x, blk["ln1"])
        x = x + _mha(h, h, blk["attn"], cfg.decoder_heads, causal=True)
        x = x + _mha(layer_norm(x, blk["ln_x"]), enc_states, blk["xattn"], cfg.decoder_heads)
        x = x + _mlp(layer_norm(x, blk["ln2"]), blk["mlp"])
    return _logits(layer_norm(x, dec["ln_post"]), dec)


# -- the KV-cached greedy decode ---------------------------------------------------


def _mha_cached(x_row: torch.Tensor, p: Params, n_heads: int, k_cache: torch.Tensor,
                v_cache: torch.Tensor, pos: int) -> torch.Tensor:
    """One row's self-attention against the running K/V cache [B, L, W]:
    row ``pos`` of each cache is written in place, then every row ≤ ``pos``
    is attended (the rest masked, as the JAX package's fixed-length scan)."""
    q = _heads(_q(x_row, p, n_heads), n_heads)
    k_cache[:, pos] = linear(x_row, p["k"])[:, 0]
    v_cache[:, pos] = linear(x_row, p["v"])[:, 0]
    valid = (torch.arange(k_cache.shape[1], device=k_cache.device) <= pos)[None, None, None, :]
    o = _attend(q, _heads(k_cache, n_heads), _heads(v_cache, n_heads), valid)
    return linear(o, p["out"])


def greedy_decode(params: Params, cfg: WhisperConfig, mel: torch.Tensor, prompt, max_len: int,
                  dtype=torch.float32, suppress_mask=None, return_logits: bool = False):
    """Greedy transcription → [B, max_len] int64 token ids (and, with
    ``return_logits``, each step's fp32 logits [B, max_len − 1, vocab]
    after suppression).

    Position t < P emits prompt[t] (the forced header); afterwards each step
    takes the argmax of the newest row's logits. Once a row emits
    ``eos_id`` every later position repeats it. The decoder's work is one
    row a step against its K/V caches; the cross-attention K/V are projected
    once from the encoder states. ``suppress_mask`` [vocab] bool: True
    forbids the id (its logit set to −1e9)."""
    dec = params["decoder"]
    dev = dec["pos"].device
    prompt = torch.as_tensor(prompt).long().to(dev)
    P = int(prompt.shape[0])
    enc_states = encoder_forward(params, cfg, mel, dtype)
    B = enc_states.shape[0]
    H = cfg.decoder_heads
    xkv = [(_heads(linear(enc_states, blk["xattn"]["k"]), H), _heads(linear(enc_states, blk["xattn"]["v"]), H))
           for blk in dec["blocks"]]
    caches = [(torch.zeros(B, max_len, cfg.d_model, dtype=dtype, device=dev),
               torch.zeros(B, max_len, cfg.d_model, dtype=dtype, device=dev)) for _ in dec["blocks"]]
    if suppress_mask is not None:
        suppress_mask = torch.as_tensor(suppress_mask, dtype=torch.bool, device=dev)
    token = prompt[:1].expand(B)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    out, steps = [token], []
    for t in range(max_len - 1):
        x = dec["token_embedding"][token].to(dtype)[:, None, :] + dec["pos"][t].to(dtype)
        for blk, (kc, vc), (xk, xv) in zip(dec["blocks"], caches, xkv):
            x = x + _mha_cached(layer_norm(x, blk["ln1"]), blk["attn"], H, kc, vc, t)
            h = layer_norm(x, blk["ln_x"])
            x = x + linear(_attend(_heads(_q(h, blk["xattn"], H), H), xk, xv), blk["xattn"]["out"])
            x = x + _mlp(layer_norm(x, blk["ln2"]), blk["mlp"])
        logits = _logits(layer_norm(x, dec["ln_post"])[:, 0], dec)
        if suppress_mask is not None:
            logits = logits.masked_fill(suppress_mask[None, :], -1e9)
        if return_logits:
            steps.append(logits)
        nxt = prompt[t + 1].expand(B) if t + 1 < P else logits.argmax(dim=-1)
        nxt = torch.where(done, torch.full_like(nxt, cfg.eos_id), nxt)
        done = done | (nxt == cfg.eos_id)
        out.append(nxt)
        token = nxt
    ids = torch.stack(out, dim=1)
    if return_logits:
        return ids, torch.stack(steps, dim=1)
    return ids


# -- the HF checkpoint converter ---------------------------------------------------


def _np(x) -> np.ndarray:
    x = x.detach().cpu().numpy() if hasattr(x, "detach") else x
    return np.asarray(x, dtype=np.float32)


def _lin(sd, prefix: str) -> Params:
    p = {"kernel": _np(sd[f"{prefix}.weight"]).T}
    if f"{prefix}.bias" in sd:
        p["bias"] = _np(sd[f"{prefix}.bias"])
    return p


def _ln(sd, prefix: str) -> Params:
    return {"scale": _np(sd[f"{prefix}.weight"]), "bias": _np(sd[f"{prefix}.bias"])}


def from_hf_whisper_state_dict(sd: dict, cfg: WhisperConfig) -> Params:
    """HF ``WhisperForConditionalGeneration.state_dict()`` → params tree of
    numpy arrays (tensors or arrays in; ``model.`` prefixes stripped, so
    ``WhisperModel`` dicts convert too). ``proj_out`` is tied to the token
    embedding in every published checkpoint, so only the embedding is read."""
    sd = {k.removeprefix("model."): v for k, v in sd.items()}

    def mha(prefix):
        return {n: _lin(sd, f"{prefix}.{n}_proj") for n in ("q", "k", "v")} | {"out": _lin(sd, f"{prefix}.out_proj")}

    def mlp(prefix):
        return {"fc1": _lin(sd, f"{prefix}.fc1"), "fc2": _lin(sd, f"{prefix}.fc2")}

    enc_blocks = [{"ln1": _ln(sd, f"{b}.self_attn_layer_norm"), "attn": mha(f"{b}.self_attn"),
                   "ln2": _ln(sd, f"{b}.final_layer_norm"), "mlp": mlp(b)}
                  for b in (f"encoder.layers.{i}" for i in range(cfg.encoder_layers))]
    dec_blocks = [{"ln1": _ln(sd, f"{b}.self_attn_layer_norm"), "attn": mha(f"{b}.self_attn"),
                   "ln_x": _ln(sd, f"{b}.encoder_attn_layer_norm"), "xattn": mha(f"{b}.encoder_attn"),
                   "ln2": _ln(sd, f"{b}.final_layer_norm"), "mlp": mlp(b)}
                  for b in (f"decoder.layers.{i}" for i in range(cfg.decoder_layers))]
    return {
        "encoder": {
            "conv1": {"kernel": _np(sd["encoder.conv1.weight"]), "bias": _np(sd["encoder.conv1.bias"])},
            "conv2": {"kernel": _np(sd["encoder.conv2.weight"]), "bias": _np(sd["encoder.conv2.bias"])},
            "pos": _np(sd["encoder.embed_positions.weight"]),
            "blocks": enc_blocks,
            "ln_post": _ln(sd, "encoder.layer_norm"),
        },
        "decoder": {
            "token_embedding": _np(sd["decoder.embed_tokens.weight"]),
            "pos": _np(sd["decoder.embed_positions.weight"]),
            "blocks": dec_blocks,
            "ln_post": _ln(sd, "decoder.layer_norm"),
        },
    }


# -- host-side audio ----------------------------------------------------------------


def read_wav(path, target_rate: int = 16000) -> np.ndarray:
    """A PCM WAV → float32 mono at ``target_rate`` (``ingest.transcripts.read_wav``:
    the standard library's reader, channels averaged, linear resampling)."""
    from evr_tpu_torch.ingest.transcripts import read_wav as read

    return read(path, target_rate)


class WhisperASR:
    """Transcription over one set of Whisper params on ``device`` (None: the
    card; "cpu" on request).

    ``detokenize`` maps token-id lists to text (an HF ``WhisperTokenizer``'s
    decode where its assets exist); without it ``transcribe`` returns id
    lists. ``detokenize="fallback"`` installs the byte-level
    ``tokenizer.fallbacks.WhisperFallbackTokenizer`` (explicitly not the
    real vocabulary), so the transcribe → transcript → speech-search path
    runs with no asset. The forced prompt is given by the caller (the
    id → language table lives in the tokenizer assets). ``max_len`` is
    clamped to the decoder's positions, ``cfg.max_target_positions``."""

    def __init__(self, params: Params, cfg: WhisperConfig, prompt_ids: list[int], max_len: int = 224,
                 detokenize: Callable[[list[int]], str] | str | None = None, dtype=torch.float32,
                 device=None):
        from .convert import params_from_numpy

        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = params_from_numpy(params, self.device)
        if detokenize == "fallback":
            from evr_tpu_torch.tokenizer.fallbacks import WhisperFallbackTokenizer

            detokenize = WhisperFallbackTokenizer.for_config(cfg).decode
            self.tokenizer_source = "fallback"
        else:
            self.tokenizer_source = "provided" if detokenize else "none"
        self.detokenize = detokenize
        self.prompt = list(prompt_ids)
        self.dtype = dtype
        self.filters = torch.from_numpy(
            mel_filter_bank(1 + cfg.n_fft // 2, cfg.num_mel_bins, cfg.sampling_rate)).to(self.device)
        self.max_len = min(max_len, cfg.max_target_positions)

    @torch.inference_mode()
    def transcribe(self, audio: np.ndarray, prompt_ids: list[int] | None = None):
        """[S] or [B, S] float32 waveform at the config's rate → texts (or id
        lists), one a row; the forced header and eos are dropped."""
        audio = np.asarray(audio, dtype=np.float32)
        if audio.ndim == 1:
            audio = audio[None, :]
        x = torch.from_numpy(np.ascontiguousarray(pad_or_trim(audio, self.cfg.n_samples))).to(self.device)
        mel = log_mel_spectrogram(x, self.filters, self.cfg.n_fft, self.cfg.hop_length)
        prompt = self.prompt if prompt_ids is None else list(prompt_ids)
        out = []
        for row in greedy_decode(self.params, self.cfg, mel, prompt, self.max_len, self.dtype).tolist():
            ids = [t for t in row if t != self.cfg.eos_id][len(prompt):]
            out.append(self.detokenize(ids) if self.detokenize else ids)
        return out

    def _windows(self, audio: np.ndarray) -> np.ndarray:
        n = self.cfg.n_samples
        count = max(1, math.ceil(audio.shape[-1] / n))
        return np.stack([pad_or_trim(audio[i * n:(i + 1) * n], n) for i in range(count)])

    def transcribe_long(self, audio: np.ndarray, prompt_ids: list[int] | None = None):
        """Audio of any length [S]: consecutive ``chunk_length`` windows
        decoded as one batch, their outputs joined (text by spaces, ids
        concatenated). A word may split across a window boundary."""
        outs = self.transcribe(self._windows(audio), prompt_ids=prompt_ids)
        if self.detokenize:
            return " ".join(o.strip() for o in outs if o.strip())
        return [t for o in outs for t in o]

    def transcribe_segments(self, audio: np.ndarray, prompt_ids: list[int] | None = None) -> list[dict]:
        """Time-anchored segments for the searchable transcript
        (``ingest/transcripts.py``): each window as ``{"start", "end",
        "text"}`` in seconds; windows with empty text are dropped. Without a
        detokenizer the text is the space-joined ids."""
        duration = audio.shape[-1] / self.cfg.sampling_rate
        chunk = float(self.cfg.chunk_length)
        segments = []
        for i, out in enumerate(self.transcribe(self._windows(audio), prompt_ids=prompt_ids)):
            text = out.strip() if self.detokenize else " ".join(str(t) for t in out)
            if text:
                segments.append({"start": i * chunk, "end": min((i + 1) * chunk, duration), "text": text})
        return segments
