"""The transcription loop: windows, temperature fallback, segments.

Port of open_whisper_kit_tpu/decode/full.py (greedy decoding, beam search
and speculative greedy decoding). Host-side control flow mirrors
whisper_full_with_state (src/whisper.cpp:6827-7800); the encoder, the
greedy, beam and speculative token loops and the multi-window loop run on
the context's device (decode/device_loop.py, decode/device_beam.py,
decode/device_speculative.py, decode/device_windows.py).
Temperature-fallback windows with t > 0 run the host-stepped sampled loop,
and `use_device_loops=False` the host-stepped greedy or beam loop (the
beam merge on the host, _beam_expand_and_merge), one host read per token.

Contexts come from a ggml-bin checkpoint (`from_file` / `from_buffer`;
q8_0/q5_0/q4_0 weights stay int8 planes for kernels K3 and K5, other
formats dequantize at load) or from seeded random weights of a preset
(`from_preset`); `decoder_int8` adds the runtime W8 logits plane (K3),
`encoder_int8` makes the encoder stack W8A8 (kernel K6). They
run on the card ("cuda") unless the caller asks for the CPU, and raise when
CUDA is missing. The greedy token steps run the decode-step kernel K2
(ops/decode_megakernel.py), and the beam token steps the beam-step kernel
K7, when `WhisperContext.mega_params` picks a mode, as the JAX package
does: by itself for a bf16 decoder whose matmul weights are all int8
planes on the card, and in every mode `FullParams.megakernel` asks for (on
the CPU through the kernels' plain versions); otherwise, and always in the
host-stepped loops, `decode_impl`. With a draft model attached
(`WhisperContext.set_draft`) and `FullParams.speculative` = gamma > 0,
greedy t = 0 windows of a loaded model decode speculatively: gamma draft
steps and one (gamma + 1)-row target verify pass a round (K2 at gamma + 1
rows when the target's mode policy picks K2 and gamma + 1 <= 8; the
draft's steps on K2 while its cache of n_text_ctx + gamma + 4 rows has a
plan), with the same output as greedy decoding.

With `FullParams.cross_kv_int8` each window's cross-KV is quantized to
int8 planes (model.QuantKV) right after its encoder pass, as the JAX
package does, in every decode path (the one-window and K-window loops,
beams, the host-stepped loops, the fallback's re-encode; a speculative
draft keeps its float cross-KV): the one-row decoder steps then run kernel
K9b (ops/experiments.py), and K2 and K7 stay off.

The rest of the whisper_full surface follows the JAX package:
* grammars (`grammar_rules`): a grammar whose token automaton fits the
  DFA budget runs in the on-device greedy loop (device_loop.GrammarOps,
  with K2 where mega_params picks it); a larger one, beams and the sampled
  fallback run the host-stepped loop with the host Grammar's penalty row;
* `ref_sampling`: the sampled and beam draws of the host-stepped loop come
  from whisper.cpp's per-decoder mt19937 streams (utils/mt19937.py), drawn
  on the host from the step's f32 probabilities;
* `abort_callback` and `logits_filter_callback` send every window to the
  host-stepped loop; the abort callback is polled once per token step, the
  logits filter is never called (the JAX package's behaviour, ROADMAP §3);
* token-level timestamps (timestamps/energy.py) per emitted segment, and
  DTW timestamps (timestamps/dtw.py) from a re-decode of each window on
  the device;
* the Silero VAD prefilter (models/silero/vad.py on the context's device,
  vad/segments.py), its segment times mapped back to the original audio.

GGUF checkpoints raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import math
import time
from pathlib import Path

import numpy as np
import torch

from ..audio import mel as mel_mod
from ..io import ggml_whisper
from ..models.whisper import model as M
from ..ops import decode_megakernel as MK
from ..ops.encoder_int8 import prepare_encoder_int8
from ..ops.quant_matmul import QuantLinear
from . import logit_rules as LR
from . import tokenizer as tok_mod
from .device_loop import HostReads
from .params import FullParams, SamplingStrategy

CHUNK_SIZE = 30          # seconds (WHISPER_CHUNK_SIZE)
DELTA_MIN = 10           # 100 ms in 10ms frames
HISTORY_CONDITIONING_TEMP_CUTOFF = 0.5
MAX_DECODERS = 8
_PROMPT_BUCKET = 64


@dataclasses.dataclass
class TokenData:
    """Mirror of whisper_token_data (include/whisper.h:84-108)."""
    id: int
    tid: int
    p: float
    plog: float
    pt: float
    ptsum: float
    t0: int = -1
    t1: int = -1
    t_dtw: int = -1
    vlen: float = 0.0


@dataclasses.dataclass
class Segment:
    t0: int                      # centiseconds
    t1: int
    text: str
    no_speech_prob: float
    tokens: list[TokenData]
    speaker_turn_next: bool = False


@dataclasses.dataclass
class Timings:
    t_mel_ms: float = 0.0
    t_encode_ms: float = 0.0
    t_decode_ms: float = 0.0
    t_sample_ms: float = 0.0
    n_encode: int = 0
    n_decode: int = 0
    n_sample: int = 0
    n_spec_accepted: int = 0   # draft tokens accepted (speculative decoding)


@dataclasses.dataclass
class TranscribeResult:
    segments: list[Segment]
    lang_id: int = -1
    timings: Timings = dataclasses.field(default_factory=Timings)

    @property
    def text(self) -> str:
        return "".join(s.text for s in self.segments)


class _DecoderState:
    """Host mirror of whisper_decoder (sequence + window state)."""

    def __init__(self):
        self.tokens: list[TokenData] = []
        self.sum_logprobs_all = 0.0
        self.result_len = 0
        self.seek_delta = 100 * CHUNK_SIZE
        self.failed = False
        self.completed = False
        self.has_ts = False
        # filled by ranking
        self.sum_logprobs = -math.inf
        self.avg_logprobs = -math.inf
        self.entropy = 0.0
        self.score = -math.inf
        self.grammar = None


def _resolve_device(device: str | torch.device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={str(device)!r} requested but CUDA is not "
                           "available")
    if dev.type == "cuda" and dev.index is None:
        # the current card is per thread: pin it here, so that the server's
        # handler and batcher threads use the card the context was made on
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _to_device(tree, device):
    """Tensors and quantized planes (both have .to) of a params tree."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    return torch.zeros_like(tree)


class WhisperContext:
    """Weights + vocab on one device; the whisper_context analog."""

    def __init__(self, cfg: M.WhisperConfig, params: M.Params,
                 vocab: tok_mod.WhisperVocab, filters: np.ndarray,
                 n_loaded: int, dtype: torch.dtype = torch.bfloat16,
                 model_type: str = "custom", decoder_int8: bool = False,
                 device: str | torch.device = "cuda", encoder_int8: bool = False):
        self.device = _resolve_device(device)
        self.cfg = cfg
        # params move to the device; the decoder's q/k/v fuse for the
        # per-token path
        params = _to_device(params, self.device)
        params["decoder"] = M.prepare_decoder(params["decoder"])
        if decoder_int8 and n_loaded > 0:
            # runtime W8: int8 planes for the vocab projection (K3)
            params["decoder"] = M.quantize_decoder_int8(params["decoder"])
        if encoder_int8 and n_loaded > 0:
            # the W8A8 encoder (kernel K6; the JAX package's also needs
            # mesh=None, and the port has no mesh); model.encode tells its
            # params apart, so every path that encodes picks it up
            params["encoder"] = prepare_encoder_int8(cfg, params["encoder"])
        self.params = params
        self.vocab = vocab
        self.filters = filters
        self.n_loaded = n_loaded
        self.dtype = dtype
        self.model_type = model_type
        self.reads = HostReads()
        self._mask_cache: dict = {}
        self._mega = None         # (decoder, mode, MegaParams), built lazily
        self._vad = None          # the Silero VAD, loaded on first use
        self.draft: WhisperContext | None = None   # speculative decoding's draft

    def set_draft(self, draft: "WhisperContext") -> None:
        """Attach a (smaller) draft model for speculative greedy decoding
        (decode/device_speculative.py; on with FullParams.speculative). The
        draft must share the target's vocabulary, dtype and audio context."""
        if (draft.vocab.n_vocab != self.vocab.n_vocab
                or draft.vocab.token_beg != self.vocab.token_beg
                or draft.vocab.token_eot != self.vocab.token_eot):
            raise ValueError("draft model vocabulary does not match the target's "
                             f"({draft.vocab.n_vocab} vs {self.vocab.n_vocab})")
        if draft.dtype != self.dtype:
            raise ValueError("draft must be loaded with the target's dtype")
        if draft.cfg.n_audio_ctx != self.cfg.n_audio_ctx:
            # the fused window loop slices the draft's mel with the target's
            # window length
            raise ValueError("draft audio context does not match the target's "
                             f"({draft.cfg.n_audio_ctx} vs {self.cfg.n_audio_ctx})")
        if draft.device != self.device:
            raise ValueError(f"draft is on {draft.device}, the target on {self.device}")
        self.draft = draft

    @classmethod
    def from_buffer(cls, buf: bytes, dtype: torch.dtype = torch.bfloat16,
                    decoder_int8: bool = False,
                    device: str | torch.device = "cuda",
                    encoder_int8: bool = False) -> "WhisperContext":
        """whisper_init_from_buffer (include/whisper.h:133)."""
        return cls.from_file(buf, dtype=dtype, decoder_int8=decoder_int8,
                             device=device, encoder_int8=encoder_int8)

    @classmethod
    def from_file(cls, path: str | Path | bytes,
                  dtype: torch.dtype = torch.bfloat16,
                  decoder_int8: bool = False,
                  device: str | torch.device = "cuda",
                  encoder_int8: bool = False) -> "WhisperContext":
        """A ggml-bin checkpoint, from a path or its bytes."""
        dev = _resolve_device(device)
        ck = ggml_whisper.load_checkpoint(path)
        cfg = M.WhisperConfig.from_hparams(ck.hparams)
        vocab = tok_mod.build_vocab(ck.tokens, ck.hparams.n_vocab)
        if ck.n_loaded == 0:
            # stub checkpoint (the tests' fake-model trick): zero weights;
            # the decode loop short-circuits (whisper.cpp:7426)
            params = _zeros_like(M.init_params(cfg, dtype=dtype, device=dev))
        else:
            params = M.params_from_checkpoint(ck, dtype=dtype)
        return cls(cfg, params, vocab, ck.mel_filters, ck.n_loaded, dtype,
                   ck.hparams.model_type, decoder_int8=decoder_int8, device=dev,
                   encoder_int8=encoder_int8)

    @classmethod
    def from_preset(cls, name: str, seed: int = 0,
                    dtype: torch.dtype = torch.bfloat16,
                    decoder_int8: bool = False,
                    device: str | torch.device = "cuda",
                    encoder_int8: bool = False) -> "WhisperContext":
        """Random-weight real-shape model, the same weights as the JAX
        package's from_preset with the same seed."""
        cfg = M.PRESETS[name]
        dev = _resolve_device(device)
        params = M.init_params(cfg, seed=seed, dtype=dtype, device=dev)
        # synthetic byte vocab is enough for pipeline mechanics
        tokens = [b"<%d>" % i for i in range(min(cfg.n_vocab, 50257))]
        vocab = tok_mod.build_vocab(tokens, cfg.n_vocab)
        filters = _synthetic_mel_filters(cfg.n_mels)
        return cls(cfg, params, vocab, filters, n_loaded=1, dtype=dtype,
                   model_type=name, decoder_int8=decoder_int8, device=dev,
                   encoder_int8=encoder_int8)

    _MEGA_WEIGHTS = ("qkv_w", "o_w", "cq_w", "co_w", "mlp0_w", "mlp1_w")

    def mega_mode(self, p: FullParams, on_card: bool | None = None,
                  draft: bool = False) -> str | None:
        """The prepare_mega mode the decode-step kernel K2 runs in for `p`,
        or None for decode_impl. `on_card` (default: this context's device
        is CUDA) stands for the JAX package's "on an accelerator"; `draft`
        resolves the mode of this context as the draft model of speculative
        decoding, whose cross-KV is never int8, so `cross_kv_int8` does not
        exclude it.

        * megakernel=None (auto): on the card, "all" when every decoder
          matmul weight is an int8 QuantLinear plane (q8_0/q5_0/q4_0
          checkpoints, decoder_int8 scope="all"); otherwise off.
        * True: also on for dense weights ("logits" when a te_logits plane
          exists, else "none"); "int8": "all", quantizing dense weights;
          "int4": "int4" (needs S % 256 == 0). These run on the CPU too.
        * False, or use_device_loops off: None.
        Structural needs: a bf16 context, the fused qkv_w, S % 128 == 0."""
        if p.megakernel is False or not p.use_device_loops:
            return None
        blocks = self.params["decoder"]["blocks"]
        on_card = self.device.type == "cuda" if on_card is None else on_card
        structural = (self.dtype == torch.bfloat16 and "qkv_w" in blocks
                      and (draft or not p.cross_kv_int8)
                      and self.cfg.n_text_state % 128 == 0)
        if not structural or not (on_card or p.megakernel in (True, "int8", "int4")):
            return None
        quant = [isinstance(blocks[n], QuantLinear) for n in self._MEGA_WEIGHTS]
        if p.megakernel == "int4":
            return "int4" if self.cfg.n_text_state % 256 == 0 else None
        if p.megakernel == "int8" or all(quant):
            return "all"
        if any(quant):
            return None                          # mixed planes: unsupported
        if p.megakernel is True:
            return "logits" if "te_logits" in self.params["decoder"] else "none"
        return None                              # auto: dense stays on decode_impl

    def mega_params(self, p: FullParams, draft: bool = False) -> MK.MegaParams | None:
        """MegaParams for `mega_mode(p, draft=draft)`, prepared once per
        decoder and mode, or None."""
        mode = self.mega_mode(p, draft=draft)
        if mode is None:
            return None
        dec = self.params["decoder"]
        if self._mega is None or self._mega[0] is not dec or self._mega[1] != mode:
            self._mega = (dec, mode, MK.prepare_mega(self.cfg, dec, quant=mode))
        return self._mega[2]

    def get_vad(self, model_path: str | None):
        """The Silero VAD on this context's device, loaded once
        (whisper.cpp:6656-6665)."""
        if self._vad is None:
            if not model_path:
                raise ValueError("vad=True requires vad_model_path")
            from ..models.silero.vad import SileroVAD
            self._vad = SileroVAD.from_file(model_path, device=self.device)
        return self._vad

    # -- compute wrappers ---------------------------------------------------

    def encode_window(self, mel_data: torch.Tensor, seek: int, audio_ctx: int):
        """mel_data (n_len, n_mel); returns (enc_out, xk, xv) for the window
        starting at frame `seek` (whisper_encode_internal, whisper.cpp:2358)."""
        n_ctx = audio_ctx if audio_ctx > 0 else self.cfg.n_audio_ctx
        n_len = mel_data.shape[0]
        i0 = min(seek, n_len)
        need = 2 * n_ctx
        if i0 + need <= n_len:
            # mel.data is bucket-padded with zeros past n_len, so this slice
            # covers the reference's zero-pad-past-the-end semantics
            window = mel_data[i0:i0 + need]
        else:  # mel shorter than one window
            window = torch.zeros((need, self.cfg.n_mels), dtype=torch.float32,
                                 device=mel_data.device)
            avail = n_len - i0
            if avail > 0:
                window[:avail] = mel_data[i0:i0 + avail]
        return M.encode_with_cross_kv(self.cfg, self.params["encoder"],
                                      self.params["decoder"], window[None])

    def quantize_cross_kv(self, p: FullParams, xk, xv):
        """(xk, xv) as the decoder reads them under `p`: int8 QuantKV planes
        with `cross_kv_int8`, else the float cross-KV as it is."""
        if not p.cross_kv_int8:
            return xk, xv
        H = self.cfg.n_text_head
        return M.quantize_cross_kv(xk, H), M.quantize_cross_kv(xv, H)

    def rule_masks(self, p: FullParams):
        key = (p.suppress_blank, p.no_timestamps, p.tdrz_enable, p.suppress_nst,
               p.suppress_regex, p.max_initial_ts)
        if key not in self._mask_cache:
            base, init = LR.build_static_masks(
                self.vocab, suppress_blank=p.suppress_blank,
                no_timestamps=p.no_timestamps, tdrz_enable=p.tdrz_enable,
                suppress_nst=p.suppress_nst, suppress_regex=p.suppress_regex,
                max_initial_ts=p.max_initial_ts, n_audio_ctx=self.cfg.n_audio_ctx)
            self._mask_cache[key] = (torch.from_numpy(base).to(self.device),
                                     torch.from_numpy(init).to(self.device))
        return self._mask_cache[key]

    @property
    def rule_config(self) -> LR.RuleConfig:
        return LR.RuleConfig(self.cfg.n_vocab, self.vocab.token_eot,
                             self.vocab.token_beg)


def _synthetic_mel_filters(n_mels: int, n_bins: int = 201) -> np.ndarray:
    """Triangular mel-like filterbank for preset (random-weight) contexts."""
    pts = np.linspace(0, n_bins - 1, n_mels + 2)
    f = np.zeros((n_mels, n_bins), np.float32)
    for m in range(n_mels):
        lo, c, hi = pts[m], pts[m + 1], pts[m + 2]
        x = np.arange(n_bins)
        up = (x - lo) / max(c - lo, 1e-6)
        dn = (hi - x) / max(hi - c, 1e-6)
        f[m] = np.clip(np.minimum(up, dn), 0, None) / n_bins
    return f


def detect_language(ctx: WhisperContext, mel: mel_mod.Mel,
                    offset_ms: int = 0) -> tuple[int, np.ndarray]:
    """whisper_lang_auto_detect_with_state (src/whisper.cpp:4021-4094)."""
    seek = offset_ms // 10
    if seek >= mel.n_len_org:
        raise ValueError("offset past end of audio")
    _, xk, xv = ctx.encode_window(mel.data, seek, 0)
    kv_k, kv_v = M.init_kv_cache(ctx.cfg, 1, dtype=ctx.dtype, device=ctx.device)
    toks = torch.tensor([[ctx.vocab.token_sot]], dtype=torch.long, device=ctx.device)
    logits, _, _ = M.decode_impl(ctx.cfg, ctx.params["decoder"], toks,
                                 kv_k, kv_v, 0, xk, xv)
    row = ctx.reads.fetch(logits[0, -1])
    lang_ids = [ctx.vocab.token_lang(i) for i in range(len(tok_mod.LANGUAGES))]
    lang_logits = row[lang_ids]
    e = np.exp(lang_logits - lang_logits.max())
    probs = e / e.sum()
    return int(np.argmax(probs)), probs


def whisper_full(ctx: WhisperContext, p: FullParams, samples: np.ndarray,
                 generator: torch.Generator | None = None) -> TranscribeResult:
    """Transcribe `samples` (16 kHz mono f32). Port of whisper_full_with_state.

    `generator` (on ctx.device) drives the sampled temperature-fallback
    decodes; by default a new one seeded with 0 per call, so a call is
    reproducible. With `p.ref_sampling` the sampled draws come from the
    context's mt19937 streams instead."""
    if generator is None:
        generator = torch.Generator(device=ctx.device).manual_seed(0)
    timings = Timings()
    vocab = ctx.vocab
    cfg = ctx.cfg
    rc = ctx.rule_config
    result = TranscribeResult(segments=[], timings=timings)

    # VAD prefilter: transcribe only speech, then map the timestamps back
    # (whisper_full, src/whisper.cpp:7937-7960 + whisper_vad :6643-6825)
    vad_mapping: list[tuple[int, int]] | None = None
    if p.vad:
        from ..vad import segments as VS
        vad_model = ctx.get_vad(p.vad_model_path)
        probs = vad_model.detect_speech(np.asarray(samples, np.float32))
        vsegs = VS.segments_from_probs(probs, p.vad_params)
        if not vsegs:
            return result
        fr = VS.filter_samples(np.asarray(samples, np.float32), vsegs, p.vad_params)
        if fr.samples.size == 0:
            return result
        samples = fr.samples
        vad_mapping = fr.mapping

    t0 = time.perf_counter()
    mel = mel_mod.log_mel_spectrogram(np.asarray(samples, np.float32),
                                      ctx.filters, device=ctx.device)
    timings.t_mel_ms = (time.perf_counter() - t0) * 1e3

    if p.token_timestamps:
        from ..timestamps import energy as E
        result._ts_state = E.TimestampState(
            E.get_signal_energy(np.asarray(samples, np.float32), 32))

    language = p.language
    if ctx.cfg.n_vocab >= 51865 and (
            language is None or language == "" or language == "auto" or p.detect_language):
        lang, _probs = detect_language(ctx, mel)
        timings.n_encode += 1
        result.lang_id = lang
        language = tok_mod.lang_str(lang)
        if p.detect_language:
            return result
    elif language is not None:
        result.lang_id = tok_mod.lang_id(language)

    seek_start = p.offset_ms // 10
    seek_end = mel.n_len_org if p.duration_ms == 0 else seek_start + p.duration_ms // 10

    if seek_end < seek_start + DELTA_MIN:
        return result

    # temperature schedule
    if p.temperature_inc > 0:
        temperatures = []
        t = p.temperature
        while t < 1.0 + 1e-6:
            temperatures.append(t)
            t += p.temperature_inc
    else:
        temperatures = [p.temperature]

    if p.strategy == SamplingStrategy.GREEDY:
        n_decoders = p.greedy.best_of
    else:
        n_decoders = max(p.greedy.best_of, p.beam_search.beam_size)
    n_decoders = max(1, n_decoders)
    if n_decoders > MAX_DECODERS:
        raise ValueError(f"too many decoders ({n_decoders} > {MAX_DECODERS})")

    if p.ref_sampling:
        # per-decoder mt19937 streams: decoder 0's engine is seeded once per
        # context (mt19937(0) at state init, whisper.cpp:3470) and persists
        # across calls; decoders 1..n-1 are reseeded with their index at
        # every entry (whisper.cpp:6929)
        from ..utils import mt19937 as MT
        if getattr(ctx, "_ref_rng0", None) is None:
            ctx._ref_rng0 = MT.MT19937(0)
        ctx._ref_rngs = [ctx._ref_rng0] + [MT.MT19937(j) for j in range(1, n_decoders)]

    no_timestamps = p.no_timestamps
    # first-release distilled models require no_timestamps (whisper.cpp:7003-7009)
    if cfg.n_text_layer == 2 and cfg.n_vocab != 51866 and not no_timestamps:
        no_timestamps = True

    # prompt history
    prompt_past0: list[int] = []
    prompt_past1: list[int] = []
    max_prompt_ctx = min(p.n_max_text_ctx, cfg.n_text_ctx // 2)

    prompt_tokens = p.prompt_tokens
    if prompt_tokens is None and p.initial_prompt:
        prompt_tokens = vocab.tokenize(p.initial_prompt)
    if prompt_tokens:
        if p.carry_initial_prompt:
            max_t = max(1, max_prompt_ctx - 1)
            prompt_past0 = list(prompt_tokens[-max_t:])
        else:
            prompt_past1 = list(prompt_tokens)

    audio_ctx = p.audio_ctx
    if audio_ctx > cfg.n_audio_ctx:
        raise ValueError(f"audio_ctx {audio_ctx} > max {cfg.n_audio_ctx}")

    # task prompt
    prompt_init = [vocab.token_sot]
    if vocab.is_multilingual:
        lid = tok_mod.lang_id(language or "en")
        result.lang_id = lid
        prompt_init.append(vocab.token_lang(lid))
        prompt_init.append(vocab.token_translate if p.translate
                           else vocab.token_transcribe)
    if no_timestamps:
        prompt_init.append(vocab.token_not)

    base_mask, init_mask = ctx.rule_masks(
        dataclasses.replace(p, no_timestamps=no_timestamps))

    # speculative decoding only ever runs on the t = 0 single-decoder greedy
    # path of a loaded model, with no grammar or host callbacks (the JAX
    # package's gate); elsewhere the draft's encoder passes would be wasted
    speculating = (p.speculative > 0 and ctx.draft is not None
                   and p.use_device_loops and ctx.n_loaded > 0
                   and p.strategy == SamplingStrategy.GREEDY
                   and p.temperature <= 0
                   and p.grammar_rules is None
                   and p.abort_callback is None
                   and p.logits_filter_callback is None)
    draft_mel = None
    if speculating:
        draft_mel = mel_mod.log_mel_spectrogram(np.asarray(samples, np.float32),
                                                ctx.draft.filters, device=ctx.device)

    if _multiwindow_eligible(ctx, p, temperatures, audio_ctx):
        _run_device_windows(
            ctx, p, result, mel, rc, temperatures, seek_start, seek_end,
            prompt_past1, prompt_init, max_prompt_ctx, no_timestamps,
            base_mask, init_mask, generator, draft_mel=draft_mel)
        if vad_mapping:
            _remap_vad(result, vad_mapping)
        return result

    seek = seek_start
    while True:
        if p.progress_callback:
            progress = 100 * (seek - seek_start) // max(1, seek_end - seek_start)
            p.progress_callback(progress)
        if seek + DELTA_MIN >= seek_end:
            break
        if p.encoder_begin_callback and not p.encoder_begin_callback():
            break

        t0 = time.perf_counter()
        _enc_out, xk, xv = ctx.encode_window(mel.data, seek, audio_ctx)
        xk, xv = ctx.quantize_cross_kv(p, xk, xv)
        dxkv = None
        if speculating:
            _, dxk, dxv = ctx.draft.encode_window(draft_mel.data, seek, 0)
            dxkv = (dxk, dxv)
            timings.n_encode += 1        # the draft's encoder pass
        timings.t_encode_ms += (time.perf_counter() - t0) * 1e3
        timings.n_encode += 1

        # drop confusing history near the very end (whisper.cpp:7060-7064)
        if seek > seek_start and seek + 500 >= seek_end:
            prompt_past0.clear()
            prompt_past1.clear()

        best_decoder_id, decoders, no_speech_prob, prompt, aborted = _decode_window_host(
            ctx, p, rc, temperatures, seek, seek_end, xk, xv,
            prompt_past0, prompt_past1, max_prompt_ctx, prompt_init,
            no_timestamps, base_mask, init_mask, timings, generator, dxkv=dxkv)
        if aborted:
            return result

        # ---- segment emission (whisper.cpp:7608-7772) ----
        best = decoders[best_decoder_id]
        seek_delta = best.seek_delta
        tokens_cur = best.tokens
        result_len = best.result_len

        is_no_speech = (no_speech_prob > p.no_speech_thold
                        and best.avg_logprobs < p.logprob_thold)

        # rolling context update
        new_past1: list[int] = []
        if (not p.carry_initial_prompt and prompt
                and prompt[0] == vocab.token_prev):
            new_past1 = prompt[1:len(prompt) - len(prompt_init)]
        prompt_past1 = new_past1
        if not is_no_speech:
            prompt_past1.extend(t.id for t in tokens_cur[:result_len])

        n_seg_before = len(result.segments)
        if tokens_cur and ctx.n_loaded > 0 and not is_no_speech:
            _emit_segments(ctx, p, result, tokens_cur, seek, seek_delta,
                           no_speech_prob)

        # DTW token timestamps over this window's new segments
        # (whisper.cpp:7727-7745)
        n_new_segs = len(result.segments) - n_seg_before
        if p.dtw_token_timestamps and n_new_segs > 0:
            from ..timestamps import dtw as DTW
            n_frames = min(min(100 * CHUNK_SIZE, seek_delta), seek_end - seek)
            result._dtw_encoder_cache = (seek, (None, xk, xv))
            DTW.compute_dtw_timestamps(ctx, result, n_seg_before, n_new_segs,
                                       seek, n_frames, language)

        # single-timestamp ending skips the whole chunk (whisper.cpp:7758-7764)
        single_ts_end = (len(tokens_cur) > 1
                         and tokens_cur[-2].id < vocab.token_beg
                         and tokens_cur[-1].id > vocab.token_beg)
        if single_ts_end:
            seek_delta = min(seek_end - seek, CHUNK_SIZE * 100)

        seek += seek_delta

    if vad_mapping:
        _remap_vad(result, vad_mapping)
    return result


def _remap_vad(result: TranscribeResult, vad_mapping) -> None:
    """Remap processed-time segments to original time
    (whisper_full_get_segment_t0/t1_from_state, whisper.cpp:7989-8027)."""
    from ..vad.segments import map_processed_to_original as _map
    for s in result.segments:
        t0m = _map(s.t0, vad_mapping)
        t1m = _map(s.t1, vad_mapping)
        if t1m - t0m < 10:
            t1m = t0m + 10
        s.t0, s.t1 = t0m, t1m
        for tk in s.tokens:
            if tk.t0 >= 0:
                tk.t0 = _map(tk.t0, vad_mapping)
            if tk.t1 >= 0:
                tk.t1 = _map(tk.t1, vad_mapping)


def _multiwindow_eligible(ctx: WhisperContext, p: FullParams,
                          temperatures, audio_ctx: int) -> bool:
    """The K-windows-per-call loop covers greedy and beam-search t=0
    decoding (the beams are ranked on the device); anything needing
    per-window host intervention (grammar, the DTW re-decode, the
    callbacks, mt19937 beams) goes one window per call."""
    beam_ok = (p.strategy == SamplingStrategy.BEAM_SEARCH
               and p.beam_search.beam_size > 1
               and not p.ref_sampling)
    return (p.use_device_loops and p.device_windows > 1
            and (p.strategy == SamplingStrategy.GREEDY or beam_ok)
            and temperatures[0] < 1e-6
            and audio_ctx == 0
            and not p.single_segment
            and not p.carry_initial_prompt
            and not p.dtw_token_timestamps
            and p.grammar_rules is None
            and p.logits_filter_callback is None
            and p.encoder_begin_callback is None
            and p.abort_callback is None)


def _run_device_windows(ctx: WhisperContext, p: FullParams,
                        result: TranscribeResult, mel: mel_mod.Mel, rc,
                        temperatures, seek_start: int, seek_end: int,
                        prompt_past1: list[int], prompt_init: list[int],
                        max_prompt_ctx: int, no_timestamps: bool,
                        base_mask, init_mask, generator, draft_mel=None) -> None:
    """Drive the transcription through the multi-window device loop
    (decode/device_windows.py); fall out to the host temperature schedule
    only for windows that trip a quality gate. `draft_mel` (speculative
    decoding): the draft model's whole-audio mel; greedy windows then
    decode by draft proposals and verify passes."""
    from . import device_windows as DW
    cfg = ctx.cfg
    vocab = ctx.vocab
    timings = result.timings
    P = max(0, max_prompt_ctx - 1)
    n_max = cfg.n_text_ctx // 2 - 4
    K = p.device_windows
    fallback_available = len(temperatures) > 1
    fscal = [p.logprob_thold, p.entropy_thold, p.no_speech_thold, p.length_penalty]
    beam_size = (p.beam_search.beam_size
                 if p.strategy == SamplingStrategy.BEAM_SEARCH else 0)
    gamma = int(p.speculative) if draft_mel is not None and beam_size == 0 else 0
    draft = None
    if gamma > 0:
        dctx = ctx.draft
        draft = DW.Draft(dctx.cfg, dctx.params["encoder"], dctx.params["decoder"],
                         draft_mel.data, gamma, *_speculative_mega(ctx, p, gamma))

    def upload_past(past_list: list[int]):
        past_list = past_list[-P:] if P > 0 else []
        buf = np.zeros(max(P, 1), np.int64)[:P]
        if past_list:
            buf[P - len(past_list):] = past_list
        return torch.from_numpy(buf).to(ctx.device), len(past_list)

    past_buf, past_len = upload_past(list(prompt_past1))
    seek = seek_start

    while seek + DELTA_MIN < seek_end:
        if p.progress_callback:
            p.progress_callback(
                100 * (seek - seek_start) // max(1, seek_end - seek_start))

        t0 = time.perf_counter()
        iscal = [vocab.token_nosp, vocab.token_prev, seek, seek_start, seek_end,
                 past_len]
        res = DW.decode_windows(
            cfg, rc, ctx.params["encoder"], ctx.params["decoder"], mel.data,
            base_mask, init_mask, past_buf, iscal, fscal,
            prompt_init=tuple(prompt_init), K=K, n_max=n_max, P=P,
            reads=ctx.reads, max_tokens=p.max_tokens,
            no_timestamps=no_timestamps, stub=ctx.n_loaded == 0,
            window_frames=2 * cfg.n_audio_ctx,
            fallback_available=fallback_available,
            mega=None if gamma else ctx.mega_params(p), beam_size=beam_size,
            draft=draft, quant_kv=p.cross_kv_int8)
        r = DW.unpack_windows_result(
            ctx.reads.fetch(DW.pack_windows_result(res)), res, K, n_max)
        past_buf = res.past_buf        # stays on the device for the next call
        # one call covers encode+decode of n_done windows; bucket the wall
        # time under decode, count every encoder pass (the draft's too), the
        # in-loop pass of a window handed to the fallback included
        timings.t_decode_ms += (time.perf_counter() - t0) * 1e3
        n_done = r["n_done"]
        timings.n_encode += (n_done + int(r["fallback"])) * (2 if gamma else 1)
        timings.n_spec_accepted += r["n_accepted"]
        # speculative: target passes = per-window prompt ingest + verify rounds
        timings.n_decode += r["n_rounds"]

        for w in range(n_done):
            rl = r["result_len"][w]
            n_tok = int(r["n_tokens"][w])
            timings.n_decode += n_tok + 1 if gamma == 0 else 1
            timings.n_sample += n_tok
            tokens_cur = [
                TokenData(int(r["tokens"][w, k]), int(r["tid"][w, k]),
                          float(r["p"][w, k]), float(r["plog"][w, k]),
                          float(r["pt"][w, k]), float(r["ptsum"][w, k]))
                for k in range(rl)]
            if tokens_cur and ctx.n_loaded > 0 and not r["is_no_speech"][w]:
                _emit_segments(ctx, p, result, tokens_cur,
                               int(r["seek"][w]), int(r["seek_delta"][w]),
                               float(r["no_speech_prob"][w]))

        next_seek = r["next_seek"]
        past_len = r["past_len"]

        if r["fallback"] and next_seek + DELTA_MIN < seek_end:
            # host temperature-fallback for the window at next_seek
            # (whisper.cpp:7069 fallback iterations)
            pb = ctx.reads.fetch(past_buf)
            past_list = [int(x) for x in pb[P - past_len:]] if past_len else []
            seek = next_seek

            t0 = time.perf_counter()
            _enc, xk, xv = ctx.encode_window(mel.data, seek, 0)
            xk, xv = ctx.quantize_cross_kv(p, xk, xv)
            timings.t_encode_ms += (time.perf_counter() - t0) * 1e3
            timings.n_encode += 1
            if seek > seek_start and seek + 500 >= seek_end:
                past_list = []

            best_id, decoders, nsp, prompt, aborted = _decode_window_host(
                ctx, p, rc, temperatures, seek, seek_end, xk, xv,
                [], past_list, max_prompt_ctx, prompt_init,
                no_timestamps, base_mask, init_mask, timings, generator)
            if aborted:
                return
            best = decoders[best_id]
            seek_delta = best.seek_delta
            tokens_cur = best.tokens
            result_len = best.result_len
            is_nsp = (nsp > p.no_speech_thold
                      and best.avg_logprobs < p.logprob_thold)
            new_past1: list[int] = []
            if prompt and prompt[0] == vocab.token_prev:
                new_past1 = prompt[1:len(prompt) - len(prompt_init)]
            past_list = new_past1
            if not is_nsp:
                past_list.extend(t.id for t in tokens_cur[:result_len])
            if tokens_cur and ctx.n_loaded > 0 and not is_nsp:
                _emit_segments(ctx, p, result, tokens_cur, seek, seek_delta,
                               nsp)
            single_ts_end = (len(tokens_cur) > 1
                             and tokens_cur[-2].id < vocab.token_beg
                             and tokens_cur[-1].id > vocab.token_beg)
            if single_ts_end:
                seek_delta = min(seek_end - seek, CHUNK_SIZE * 100)
            next_seek = seek + seek_delta
            past_buf, past_len = upload_past(past_list)
        elif n_done == 0 and next_seek == seek:
            break   # safety: no progress possible

        seek = next_seek

    if p.progress_callback:
        p.progress_callback(100)


def _device_greedy_window(ctx, p, rc, decoders, prompt, xk, xv,
                          base_mask, init_mask, seek, seek_end,
                          no_timestamps, timings, grammar=None) -> float:
    """One window through the on-device greedy loop (decode/device_loop.py,
    its token steps through K2 where ctx.mega_params picks a mode; `grammar`
    the token automaton of a grammar that fits); fills decoders[0], returns
    no_speech_prob."""
    from . import device_loop as DL
    cfg, vocab = ctx.cfg, ctx.vocab
    t0 = time.perf_counter()
    toks, T_real = _pad_prompt(cfg, prompt, ctx.device)
    n_max = cfg.n_text_ctx // 2 - 4
    res = DL.decode_segment(
        cfg, rc, ctx.params["decoder"], toks, xk, xv, base_mask, init_mask,
        (T_real, vocab.token_nosp, seek, seek_end), n_max=n_max,
        reads=ctx.reads, max_tokens=p.max_tokens,
        single_segment=p.single_segment, no_timestamps=no_timestamps,
        stub=ctx.n_loaded == 0, cache_dtype=ctx.dtype, mega=ctx.mega_params(p),
        grammar=grammar)
    r = DL.unpack_segment_result(ctx.reads.fetch(DL.pack_segment_result(res)),
                                 n_max)
    n_tok = r["n_tokens"]
    _fill_decoder(decoders[0], r, n_tok)
    timings.t_decode_ms += (time.perf_counter() - t0) * 1e3
    timings.n_decode += n_tok + 1
    timings.n_sample += n_tok
    return r["no_speech_prob"]


def _speculative_mega(ctx, p: FullParams, gamma: int):
    """(dmega, tmega): K2's params for the draft's steps and for the verify
    pass, each None for decode_impl. K2 takes gamma + 1 <= 8 verify rows,
    and a model whose speculative cache (n_text_ctx + gamma + 4 rows) is
    within `MK.mega_step_max_cache` (at n_text_ctx 448: the draft to gamma
    60)."""
    from .device_speculative import cache_rows

    def fits(cfg):
        return cache_rows(cfg, gamma) <= MK.mega_step_max_cache(cfg)
    return (ctx.draft.mega_params(p, draft=True) if fits(ctx.draft.cfg) else None,
            ctx.mega_params(p) if gamma + 1 <= 8 and fits(ctx.cfg) else None)


def _device_speculative_window(ctx, p, rc, decoders, prompt, xk, xv, dxkv,
                               base_mask, init_mask, seek, seek_end,
                               no_timestamps, timings) -> float:
    """One window through the speculative loop (draft proposals and
    multi-token verify passes, decode/device_speculative.py); fills
    decoders[0], returns no_speech_prob."""
    from . import device_loop as DL
    from . import device_speculative as DS
    cfg, vocab = ctx.cfg, ctx.vocab
    t0 = time.perf_counter()
    toks, T_real = _pad_prompt(cfg, prompt, ctx.device)
    n_max = cfg.n_text_ctx // 2 - 4
    gamma = int(p.speculative)
    dxk, dxv = dxkv
    dmega, tmega = _speculative_mega(ctx, p, gamma)
    res, n_acc, n_rounds = DS.decode_segment_speculative(
        cfg, ctx.draft.cfg, rc, ctx.params["decoder"], ctx.draft.params["decoder"], toks,
        xk, xv, dxk, dxv, base_mask, init_mask, (T_real, vocab.token_nosp, seek, seek_end),
        n_max=n_max, reads=ctx.reads, gamma=gamma, max_tokens=p.max_tokens,
        single_segment=p.single_segment, no_timestamps=no_timestamps,
        cache_dtype=ctx.dtype, dmega=dmega, tmega=tmega)
    flat = ctx.reads.fetch(torch.cat([DL.pack_segment_result(res),
                                      torch.stack([n_acc, n_rounds]).float()]))
    r = DL.unpack_segment_result(flat[:-2], n_max)
    n_tok = r["n_tokens"]
    _fill_decoder(decoders[0], r, n_tok)
    timings.t_decode_ms += (time.perf_counter() - t0) * 1e3
    # target passes: the prompt ingest and one verify pass a round
    timings.n_decode += int(flat[-1]) + 1
    timings.n_sample += n_tok
    timings.n_spec_accepted += int(flat[-2])
    return r["no_speech_prob"]


def _device_beam_window(ctx, p, rc, decoders, prompt, xk, xv,
                        base_mask, init_mask, seek, seek_end,
                        no_timestamps, timings) -> float:
    """One window through the on-device beam loop (decode/device_beam.py,
    its token steps through K7 where ctx.mega_params picks a mode); fills
    `decoders`, returns no_speech_prob."""
    from . import device_beam as DB
    cfg, vocab = ctx.cfg, ctx.vocab
    n_dec = len(decoders)
    t0 = time.perf_counter()
    toks, T_real = _pad_prompt(cfg, prompt, ctx.device)
    n_max = cfg.n_text_ctx // 2 - 4
    res = DB.decode_segment_beam(
        cfg, rc, ctx.params["decoder"], toks, xk, xv, base_mask, init_mask,
        (T_real, vocab.token_nosp, seek, seek_end), beam_size=n_dec, n_max=n_max,
        reads=ctx.reads, max_tokens=p.max_tokens, single_segment=p.single_segment,
        no_timestamps=no_timestamps, stub=ctx.n_loaded == 0,
        mega=ctx.mega_params(p), cache_dtype=ctx.dtype)
    rows = DB.unpack_beam_result(ctx.reads.fetch(DB.pack_beam_result(res)), n_dec, n_max)
    for d, r in zip(decoders, rows):
        # each beam's own length: an early-ended beam's buffer tail is stale
        _fill_decoder(d, r, r["n_valid"])
    n_tok = rows[0]["n_tokens"]
    timings.t_decode_ms += (time.perf_counter() - t0) * 1e3
    timings.n_decode += n_tok + 1
    timings.n_sample += n_tok
    return rows[0]["no_speech_prob"]


def _host_stepped_window(ctx, p, rc, decoders, prompt, xk, xv,
                         base_mask, init_mask, seek, seek_end,
                         no_timestamps, t_cur, beam_mode, timings,
                         generator) -> tuple[float, bool]:
    """One window through the host-stepped loop: the sampled (t > 0,
    best_of decoders) fallback, greedy or beam search (the merge on the
    host) when device loops are off, and every window with a grammar the
    on-device loop cannot take, `ref_sampling` draws or a per-token
    callback. One host read per token. Fills `decoders`; returns
    (no_speech_prob, aborted)."""
    cfg, vocab = ctx.cfg, ctx.vocab
    dec_params = ctx.params["decoder"]
    n_dec_cur = len(decoders)
    # prompt decode, B=1
    t0 = time.perf_counter()
    kv_k, kv_v = M.init_kv_cache(cfg, 1, dtype=ctx.dtype, device=ctx.device)
    toks, T_real = _pad_prompt(cfg, prompt, ctx.device)
    logits_all, kv_k, kv_v = M.decode_impl(
        cfg, dec_params, toks, kv_k, kv_v, 0, xk, xv, logits_pos=T_real - 1)
    last_logits = logits_all[:, 0]  # (1, V)
    nsp = LR.compute_no_speech_prob(last_logits[0], vocab.token_nosp)
    no_speech_prob = float(ctx.reads.fetch(nsp))
    timings.t_decode_ms += (time.perf_counter() - t0) * 1e3
    timings.n_decode += 1

    # decoders share the window's cross-KV (batch 1); each gets its own
    # copy of the prompt's self-KV
    kv_k = kv_k.repeat_interleave(n_dec_cur, dim=1)
    kv_v = kv_v.repeat_interleave(n_dec_cur, dim=1)
    step_logits = last_logits.repeat_interleave(n_dec_cur, dim=0)
    kv_head = T_real

    n_max = cfg.n_text_ctx // 2 - 4
    for i in range(n_max):
        # ---- rules + sampling (on device, batched over decoders) ----
        t0 = time.perf_counter()
        st = _beam_state(decoders, vocab, ctx.device)
        gmask = None
        if p.grammar_rules is not None:
            gmask = torch.from_numpy(np.stack(
                [d.grammar.penalty_mask(vocab, p.grammar_penalty)
                 if d.grammar is not None and not (d.completed or d.failed)
                 else np.zeros(cfg.n_vocab, np.float32)
                 for d in decoders])).to(ctx.device)
        f_logits, f_logprobs, f_probs = LR.apply_rules(
            rc, step_logits, base_mask, init_mask, st, t_cur, gmask)
        # mt19937 draws (whisper.cpp:6504-6508, 6519-6592): on the host,
        # from the step's f32 probabilities, each active decoder on its own
        # stream
        draws = p.ref_sampling and (beam_mode or t_cur >= 1e-6)
        if draws:
            from ..utils import mt19937 as MT
            pt, ptsum, tid = LR.ts_aggregates(rc, f_probs)
            V = f_probs.shape[1]
            a = ctx.reads.fetch(torch.cat([f_probs, f_logprobs, pt[:, None], ptsum[:, None],
                                           tid[:, None].float()], dim=1))
            probs_np, lp_np = a[:, :V], a[:, V:2 * V]
            pt_a, pts_a, tid_a = a[:, 2 * V], a[:, 2 * V + 1], a[:, 2 * V + 2]
        if beam_mode:
            k = p.beam_search.beam_size
            if draws:
                top_id = np.zeros((n_dec_cur, k), np.int64)
                for j, d in enumerate(decoders):
                    if d.completed or d.failed:
                        continue
                    top_id[j] = MT.DiscreteDistribution(probs_np[j]).draw_k(
                        ctx._ref_rngs[j], k)
                _beam_expand_and_merge(
                    decoders, top_id, np.take_along_axis(probs_np, top_id, 1),
                    np.take_along_axis(lp_np, top_id, 1), pt_a, pts_a, tid_a, i,
                    vocab.token_beg)
            else:
                out = LR.sample_topk(rc, k, f_logits, f_logprobs, f_probs)
                a = ctx.reads.fetch(torch.cat([x.double().reshape(n_dec_cur, -1)
                                               for x in out], dim=1))
                _beam_expand_and_merge(decoders, a[:, :k], a[:, k:2 * k],
                                       a[:, 2 * k:3 * k], a[:, 3 * k], a[:, 3 * k + 1],
                                       a[:, 3 * k + 2], i, vocab.token_beg)
            src = np.array([d._src for d in decoders], np.int64)
            if not np.array_equal(src, np.arange(n_dec_cur)):
                kv_k, kv_v = M.reorder_kv(kv_k, kv_v, torch.from_numpy(src).to(ctx.device))
            for d in decoders:
                if d.grammar is not None and d.tokens and not (d.completed or d.failed):
                    d.grammar.accept_token(vocab.id_to_token[d.tokens[-1].id])
        else:
            if draws:
                tok_a = np.zeros(n_dec_cur, np.int64)
                for j, d in enumerate(decoders):
                    if d.completed or d.failed:
                        continue
                    tok_a[j] = MT.DiscreteDistribution(probs_np[j])(ctx._ref_rngs[j])
                p_a = probs_np[np.arange(n_dec_cur), tok_a]
                lp_a = lp_np[np.arange(n_dec_cur), tok_a]
            else:
                if t_cur < 1e-6:
                    out = LR.sample_greedy(rc, f_logits, f_logprobs, f_probs)
                else:
                    out = LR.sample_multinomial(rc, generator, f_logits, f_logprobs,
                                                f_probs)
                tok_a, p_a, lp_a, pt_a, pts_a, tid_a = ctx.reads.fetch(
                    torch.stack([x.double() for x in out]))
            for j, d in enumerate(decoders):
                if d.completed or d.failed:
                    continue
                td = TokenData(int(tok_a[j]), int(tid_a[j]), float(p_a[j]),
                               float(lp_a[j]), float(pt_a[j]), float(pts_a[j]))
                if td.id >= vocab.token_beg:
                    td.tid = td.id
                    td.pt = td.p
                d.tokens.append(td)
                d.sum_logprobs_all += td.plog
                if d.grammar is not None:
                    d.grammar.accept_token(vocab.id_to_token[td.id])
        timings.t_sample_ms += (time.perf_counter() - t0) * 1e3
        timings.n_sample += 1

        # ---- per-decoder state update (whisper.cpp:7355-7459) ----
        for d in decoders:
            if d.completed or d.failed:
                continue
            token = d.tokens[-1]
            if token.id > vocab.token_beg:
                seek_delta_new = 2 * (token.id - vocab.token_beg)
                if (d.has_ts and d.seek_delta > seek_delta_new
                        and d.result_len < i):
                    d.failed = True
                    continue
                d.seek_delta = seek_delta_new
                d.result_len = i + 1
                d.has_ts = True

            if (token.id == vocab.token_eot
                    or (p.max_tokens > 0 and i >= p.max_tokens)
                    or (d.has_ts and seek + d.seek_delta + DELTA_MIN >= seek_end)):
                if d.result_len == 0 and not no_timestamps:
                    if seek + d.seek_delta + DELTA_MIN >= seek_end:
                        d.result_len = i + 1
                    else:
                        d.failed = True
                        continue
                if p.single_segment or no_timestamps:
                    d.result_len = i + 1
                    d.seek_delta = 100 * CHUNK_SIZE
                d.completed = True
                continue

            # stub-model short-circuit (tests; whisper.cpp:7426-7431)
            if ctx.n_loaded == 0:
                d.seek_delta = 100 * CHUNK_SIZE
                d.completed = True
                continue

            # repetition-loop bail-out
            if i == n_max - 1 and (d.result_len == 0
                                   or d.seek_delta < 100 * CHUNK_SIZE // 2):
                d.failed = True
                continue

        if all(d.completed or d.failed for d in decoders):
            break

        # ---- next decode step, all decoders ----
        t0 = time.perf_counter()
        next_tok = torch.tensor(
            [[d.tokens[-1].id if d.tokens else vocab.token_eot]
             for d in decoders], dtype=torch.long, device=ctx.device)
        step_logits_all, kv_k, kv_v = M.decode_impl(
            cfg, dec_params, next_tok, kv_k, kv_v, kv_head, xk, xv)
        step_logits = step_logits_all[:, 0]
        kv_head += 1
        timings.t_decode_ms += (time.perf_counter() - t0) * 1e3
        timings.n_decode += 1

        # per-step abort check (whisper.cpp polls ggml_abort_callback per
        # graph compute; here once per token step)
        if p.abort_callback is not None and p.abort_callback():
            return no_speech_prob, True

    return no_speech_prob, False


def _decode_window_host(ctx: WhisperContext, p: FullParams, rc,
                        temperatures, seek: int, seek_end: int, xk, xv,
                        prompt_past0: list[int], prompt_past1: list[int],
                        max_prompt_ctx: int, prompt_init: list[int],
                        no_timestamps: bool, base_mask, init_mask,
                        timings: Timings, generator, dxkv=None):
    """Temperature-fallback decode of ONE 30 s window (the body of the
    reference's `for (int it = 0; ...)` loop, whisper.cpp:7069-7605).
    `dxkv`: the draft's (xk, xv) for this window when decoding
    speculatively.

    Returns (best_decoder_id, decoders, no_speech_prob, prompt, aborted)."""
    vocab = ctx.vocab
    best_decoder_id = 0
    decoders: list[_DecoderState] = []
    no_speech_prob = 0.0
    prompt: list[int] = []

    for it, t_cur in enumerate(temperatures):
        if p.strategy == SamplingStrategy.GREEDY:
            n_dec_cur = p.greedy.best_of if t_cur > 0 else 1
        else:
            n_dec_cur = p.greedy.best_of if t_cur > 0 else p.beam_search.beam_size
        n_dec_cur = max(1, n_dec_cur)
        beam_mode = p.strategy == SamplingStrategy.BEAM_SEARCH and t_cur <= 0
        decoders = [_DecoderState() for _ in range(n_dec_cur)]
        if p.grammar_rules is not None:
            from . import grammar as G
            base_grammar = (p.grammar_rules if isinstance(p.grammar_rules, G.Grammar)
                            else G.Grammar.from_gbnf(p.grammar_rules))
            for d in decoders:
                d.grammar = base_grammar.copy()

        # build prompt (whisper.cpp:7121-7148)
        prompt = []
        if p.n_max_text_ctx > 0 and t_cur < HISTORY_CONDITIONING_TEMP_CUTOFF:
            can0 = p.carry_initial_prompt and prompt_past0
            can1 = bool(prompt_past1)
            if max_prompt_ctx > 0 and (can0 or can1):
                prompt.append(vocab.token_prev)
                n_take0 = 0
                if can0:
                    n_take0 = len(prompt_past0)
                    prompt.extend(prompt_past0)
                n_take1 = min(max_prompt_ctx - n_take0 - 1, len(prompt_past1))
                if n_take1 > 0:
                    prompt.extend(prompt_past1[-n_take1:])
        prompt.extend(prompt_init)

        # the on-device loops take t = 0 windows with no per-token host
        # callback; a grammar rides the greedy loop when its token automaton
        # fits the DFA budget, else the window is host-stepped
        gops = _grammar_device_ops(ctx, p) if t_cur < 1e-6 else None
        on_device = (p.use_device_loops and t_cur < 1e-6
                     and p.logits_filter_callback is None
                     and p.abort_callback is None)
        use_device_loop = (on_device and n_dec_cur == 1
                           and (p.grammar_rules is None or gops is not None))
        use_device_beam = (on_device and beam_mode and n_dec_cur > 1
                           and not p.ref_sampling and p.grammar_rules is None)
        # speculative greedy: draft proposals + one multi-token verify pass
        # a round; the same output as the greedy loop
        if (use_device_loop and dxkv is not None and p.grammar_rules is None
                and ctx.n_loaded > 0):
            no_speech_prob = _device_speculative_window(
                ctx, p, rc, decoders, prompt, xk, xv, dxkv, base_mask, init_mask,
                seek, seek_end, no_timestamps, timings)
        elif use_device_beam:
            no_speech_prob = _device_beam_window(
                ctx, p, rc, decoders, prompt, xk, xv, base_mask, init_mask,
                seek, seek_end, no_timestamps, timings)
        elif use_device_loop:
            no_speech_prob = _device_greedy_window(
                ctx, p, rc, decoders, prompt, xk, xv, base_mask, init_mask,
                seek, seek_end, no_timestamps, timings, grammar=gops)
        else:
            no_speech_prob, aborted = _host_stepped_window(
                ctx, p, rc, decoders, prompt, xk, xv, base_mask, init_mask,
                seek, seek_end, no_timestamps, t_cur, beam_mode, timings,
                generator)
            if aborted:
                return best_decoder_id, decoders, no_speech_prob, prompt, True

        # ---- rank sequences (whisper.cpp:7545-7580) ----
        best_decoder_id, success = _rank_decoders(
            decoders, p, no_speech_prob, it == len(temperatures) - 1)
        if success:
            break

    return best_decoder_id, decoders, no_speech_prob, prompt, False


def _grammar_device_ops(ctx: WhisperContext, p: FullParams):
    """device_loop.GrammarOps for the on-device greedy loop, or None when
    there is no grammar or its automaton exceeds the DFA budget (the window
    is then host-stepped). Cached on the Grammar object, or on the context
    for GBNF text, per penalty and device."""
    if p.grammar_rules is None:
        return None
    from . import device_loop as DL
    from . import grammar as G
    key = (float(p.grammar_penalty), ctx.device)
    if isinstance(p.grammar_rules, G.Grammar):
        cached = p.grammar_rules.__dict__.get("_device_ops_cache")
        if cached is not None and cached[0] == key:
            return cached[1]
        base = p.grammar_rules
    else:
        text_key = (str(p.grammar_rules), key)
        cached = getattr(ctx, "_gdfa_cache", None)
        if cached is not None and cached[0] == text_key:
            return cached[1]
        base = G.Grammar.from_gbnf(p.grammar_rules)
    dfa = G.build_token_dfa(base.copy(), ctx.vocab)
    ops = DL.GrammarOps.from_dfa(dfa, key[0], ctx.device) if dfa is not None else None
    if isinstance(p.grammar_rules, G.Grammar):
        p.grammar_rules.__dict__["_device_ops_cache"] = (key, ops)
    else:
        ctx._gdfa_cache = (text_key, ops)
    return ops


def _pad_prompt(cfg: M.WhisperConfig, prompt: list[int], device):
    """Bucket-pad the prompt to a multiple of 64 tokens (the JAX package's
    compile buckets; kept so both sides run the same shapes).

    Returns (toks (1, T_pad) long tensor, T_real)."""
    T_real = len(prompt)
    T_pad = min(cfg.n_text_ctx,
                max(_PROMPT_BUCKET, -(-T_real // _PROMPT_BUCKET) * _PROMPT_BUCKET))
    toks = np.zeros((1, T_pad), np.int64)
    toks[0, :T_real] = prompt
    return torch.from_numpy(toks).to(device), T_real


def _fill_decoder(d: _DecoderState, r: dict, n_tok: int):
    """Copy the decoder's fields out of an unpacked device-loop result."""
    d.tokens = [TokenData(int(r["tokens"][k]), int(r["tid"][k]),
                          float(r["p"][k]), float(r["plog"][k]),
                          float(r["pt"][k]), float(r["ptsum"][k]))
                for k in range(n_tok)]
    d.sum_logprobs_all = float(r["sum_logprobs_all"])
    d.result_len = int(r["result_len"])
    d.seek_delta = int(r["seek_delta"])
    d.has_ts = bool(r["has_ts"])
    d.completed = bool(r["completed"])
    d.failed = bool(r["failed"])


def _rank_decoders(decoders, p, no_speech_prob, is_last_temperature):
    """Sequence ranking + QA gates (whisper.cpp:7545-7605).

    Returns (best_decoder_id, success)."""
    best_score = -math.inf
    best_id = 0
    for j, d in enumerate(decoders):
        if d.failed:
            continue
        d.tokens = d.tokens[:d.result_len]
        _score_sequence(d, p.length_penalty)
        if d.result_len > 32 and d.entropy < p.entropy_thold:
            d.failed = True
            continue
        if d.score > best_score:
            best_score = d.score
            best_id = j
    success = True
    if not is_last_temperature:
        d = decoders[best_id]
        if d.failed or (d.avg_logprobs < p.logprob_thold
                        and no_speech_prob < p.no_speech_thold):
            success = False
    return best_id, success


def _beam_state(decoders: list[_DecoderState], vocab: tok_mod.WhisperVocab,
                device) -> LR.BeamState:
    B = len(decoders)
    is_initial = np.zeros(B, bool)
    last_ts = np.zeros(B, bool)
    penult_ts = np.zeros(B, bool)
    has_ts = np.zeros(B, bool)
    ts_min = np.zeros(B, np.int64)
    for j, d in enumerate(decoders):
        n = len(d.tokens)
        is_initial[j] = n == 0
        last_ts[j] = n > 0 and d.tokens[-1].id >= vocab.token_beg
        penult_ts[j] = n < 2 or d.tokens[-2].id >= vocab.token_beg
        has_ts[j] = d.has_ts
        ts_min[j] = vocab.token_beg + d.seek_delta // 2 if d.has_ts else 0
    t = lambda a: torch.from_numpy(a).to(device)
    return LR.BeamState(t(is_initial), t(last_ts), t(penult_ts), t(has_ts),
                        t(ts_min))


def _beam_expand_and_merge(decoders, top_id, top_p, top_lp, pt, ptsum, tid, i,
                           token_beg: int):
    """Candidate generation + global merge on the host (whisper.cpp:7301-7352),
    comparing sequences token by token. Sets d._src on every decoder for
    the KV gather."""
    candidates = []
    for j, d in enumerate(decoders):
        d._src = j
        if d.completed or d.failed:
            continue
        for c in range(top_id.shape[1]):
            td = TokenData(int(top_id[j, c]), int(tid[j]), float(top_p[j, c]),
                           float(top_lp[j, c]), float(pt[j]), float(ptsum[j]))
            if td.id >= token_beg:
                td.tid = td.id
                td.pt = td.p
            candidates.append((d.sum_logprobs_all + td.plog, j, td, d))

    # sort by sum_logprobs desc, then source decoder index asc
    candidates.sort(key=lambda c: (-c[0], c[1]))

    # assign top candidates to the active decoders, skipping duplicates
    new_states = []
    cur = 0
    for j, d in enumerate(decoders):
        if d.completed or d.failed:
            new_states.append(None)
            continue
        if cur >= len(candidates):
            cur = 0
        sum_lp, src_j, td, src_d = candidates[cur]
        cur += 1
        # dedupe identical sequences (compare token ids incl. the new one)
        if i > 0:
            seq = [t.id for t in src_d.tokens] + [td.id]
            while cur < len(candidates):
                s2 = candidates[cur]
                seq2 = [t.id for t in s2[3].tokens] + [s2[2].id]
                if seq2 == seq:
                    cur += 1
                else:
                    break
        new_states.append((sum_lp, src_j, td, src_d))

    # apply (copy the source sequence and grammar + append the token)
    snapshot = {j: (list(d.tokens), d.seek_delta, d.has_ts, d.result_len,
                    d.grammar.copy() if d.grammar is not None else None)
                for j, d in enumerate(decoders)}
    for d, ns in zip(decoders, new_states):
        if ns is None:
            continue
        sum_lp, src_j, td, _ = ns
        toks, sd, hts, rl, gr = snapshot[src_j]
        d.tokens = list(toks)
        d.tokens.append(dataclasses.replace(td))
        d.sum_logprobs_all = sum_lp
        d.seek_delta = sd
        d.has_ts = hts
        d.result_len = rl
        d.grammar = gr.copy() if gr is not None else None
        d._src = src_j


def _score_sequence(d: _DecoderState, length_penalty: float):
    """whisper_sequence_score (src/whisper.cpp:6595-6641)."""
    if d.result_len == 0:
        return
    total = sum(t.plog for t in d.tokens[:d.result_len])
    d.sum_logprobs = total
    d.avg_logprobs = total / d.result_len
    penalty = d.result_len
    if length_penalty > 0:
        penalty = ((5.0 + penalty) / 6.0) ** length_penalty
    d.score = total / penalty

    counts: dict[int, int] = {}
    lo = max(0, d.result_len - 32)
    for t in d.tokens[lo:d.result_len]:
        counts[t.id] = counts.get(t.id, 0) + 1
    cnt = d.result_len - lo
    entropy = 0.0
    for c in counts.values():
        pr = c / cnt
        entropy -= pr * math.log(pr)
    d.entropy = entropy


def _emit_segments(ctx: WhisperContext, p: FullParams, result: TranscribeResult,
                   tokens_cur: list[TokenData], seek: int, seek_delta: int,
                   no_speech_prob: float):
    """Token walk -> timestamped segments (whisper.cpp:7638-7757)."""
    vocab = ctx.vocab
    i0 = 0
    t0 = seek + 2 * (tokens_cur[0].tid - vocab.token_beg)
    text = ""
    speaker_turn_next = False

    i = 0
    n = len(tokens_cur)
    while i < n:
        tk = tokens_cur[i]
        if p.print_special or tk.id < vocab.token_eot:
            text += vocab.token_to_str(tk.id)
        if p.tdrz_enable and tk.id == vocab.token_solm:
            speaker_turn_next = True

        if tk.id > vocab.token_beg and not p.single_segment:
            t1 = seek + 2 * (tk.tid - vocab.token_beg)
            if text:
                seg = Segment(t0, t1, text, no_speech_prob,
                              list(tokens_cur[i0:i + 1]), speaker_turn_next)
                result.segments.append(seg)
                _post_segment(ctx, p, result)
            text = ""
            while i < n and tokens_cur[i].id > vocab.token_beg:
                i += 1
            i -= 1
            t0 = t1
            i0 = i + 1
            speaker_turn_next = False
        i += 1

    if text:
        t1 = seek + seek_delta
        seg = Segment(t0, t1, text, no_speech_prob,
                      list(tokens_cur[i0:]), speaker_turn_next)
        result.segments.append(seg)
        _post_segment(ctx, p, result)


def _post_segment(ctx: WhisperContext, p: FullParams, result: TranscribeResult):
    n_new = 1
    if p.token_timestamps:
        from ..timestamps import energy as E
        E.compute_token_level_timestamps(ctx, result, len(result.segments) - 1,
                                         p.thold_pt, p.thold_ptsum)
        if p.max_len > 0:
            n_new = _wrap_segment(ctx, result, p.max_len, p.split_on_word)
    if p.new_segment_callback:
        p.new_segment_callback(result, n_new)


def _wrap_segment(ctx: WhisperContext, result: TranscribeResult,
                  max_len: int, split_on_word: bool) -> int:
    """whisper_wrap_segment (src/whisper.cpp:6077-6129): split the last
    segment into pieces of at most max_len UTF-8 chars (with token-level
    timestamps)."""
    vocab = ctx.vocab
    segment = result.segments[-1]
    res = segment.t0
    acc = ""
    acc_tokens: list[TokenData] = []
    pieces: list[Segment] = []

    for tk in segment.tokens:
        if tk.id >= vocab.token_eot:
            continue
        txt = vocab.token_to_str(tk.id)
        cur = txt
        if split_on_word and acc and cur.startswith(" "):
            trim = True
        else:
            trim = False
        if len(acc) + len(cur) > max_len and acc or trim and len(acc) + len(cur) > max_len:
            pieces.append(Segment(res, tk.t0 if tk.t0 >= 0 else segment.t1,
                                  acc, segment.no_speech_prob, acc_tokens))
            res = tk.t0 if tk.t0 >= 0 else segment.t0
            acc = cur.lstrip() if split_on_word else cur
            acc_tokens = [tk]
        else:
            acc += cur
            acc_tokens.append(tk)
    pieces.append(Segment(res, segment.t1, acc, segment.no_speech_prob,
                          acc_tokens, segment.speaker_turn_next))
    result.segments[-1:] = pieces
    return len(pieces)
