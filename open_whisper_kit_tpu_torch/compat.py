"""whisper.h-compatible function surface of the PyTorch port (port of
open_whisper_kit_tpu/compat.py).

1:1 name/semantics mapping of the reference C API (include/whisper.h) onto
the framework, so code written against whisper.cpp (or its go/java/ruby
bindings' shapes) ports mechanically:

    import open_whisper_kit_tpu_torch.compat as whisper
    ctx = whisper.whisper_init_from_file("ggml-base.en.bin")
    params = whisper.whisper_full_default_params(whisper.WHISPER_SAMPLING_GREEDY)
    whisper.whisper_full(ctx, params, samples, len(samples))
    for i in range(whisper.whisper_full_n_segments(ctx)):
        print(whisper.whisper_full_get_segment_text(ctx, i))

Covers the complete WHISPER_API surface of include/whisper.h (123
symbols; verified by tests/test_compat.py introspecting the header):
init (file/buffer/loader, with/without state), mel (pcm_to_mel/set_mel),
low-level encode/decode/get_logits over an explicit whisper_state, the
whisper_full family incl. every *_from_state accessor, model_n_*
accessors, tokens/languages, the whisper_vad_* C surface, timings and
bench helpers. The context owns a default state, like whisper_init;
*_no_state variants create none and require explicit states.

As in whisper.cpp, `WhisperContextParams.use_gpu` picks the card
(`cuda:<gpu_device>`) or the CPU, and so do the VAD context params; a
context on the card raises when CUDA is missing, and never falls back to
the CPU. The `dtype` extension defaults to torch.bfloat16.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .decode import full as F
from .decode import tokenizer as T
from .decode.params import FullParams, SamplingStrategy
from .utils import timings as TM

WHISPER_SAMPLING_GREEDY = SamplingStrategy.GREEDY
WHISPER_SAMPLING_BEAM_SEARCH = SamplingStrategy.BEAM_SEARCH

WHISPER_SAMPLE_RATE = 16000
WHISPER_N_FFT = 400
WHISPER_HOP_LENGTH = 160
WHISPER_CHUNK_SIZE = 30


class WhisperCompatState:
    """whisper_state: mel, encoder output / cross-KV, self-KV cache, the
    last decode's logits and the last whisper_full result
    (include/whisper.h:210-241 init/free/own-state family)."""

    def __init__(self, ctx: "WhisperCompatContext"):
        self._cc = ctx
        self.mel = None                # audio.mel.Mel
        self.xk = None                 # cross-KV after whisper_encode
        self.xv = None
        self.kv_k = None               # self-attention KV cache (B=1)
        self.kv_v = None
        self.logits = np.zeros((0, ctx.ctx.cfg.n_vocab), np.float32)
        self.result: F.TranscribeResult = F.TranscribeResult(segments=[])


class WhisperCompatContext:
    """whisper_context (+ a default whisper_state, like whisper_init)."""

    def __init__(self, ctx: F.WhisperContext, hparams=None,
                 with_state: bool = True):
        self.ctx = ctx
        self.hparams = hparams
        self.state: WhisperCompatState | None = (
            WhisperCompatState(self) if with_state else None)

    # back-compat alias: round-1 compat stored the result on the context
    @property
    def result(self) -> F.TranscribeResult:
        return self.state.result if self.state else F.TranscribeResult(segments=[])

    @result.setter
    def result(self, r):
        if self.state is None:
            self.state = WhisperCompatState(self)
        self.state.result = r


def _require_state(ctx: WhisperCompatContext) -> WhisperCompatState:
    if ctx.state is None:
        raise ValueError("context was created no_state; pass a state "
                         "(use the *_with_state variant)")
    return ctx.state


# -- context params (include/whisper.h:116-129) -------------------------------

@dataclasses.dataclass
class WhisperContextParams:
    use_gpu: bool = True
    flash_attn: bool = False
    gpu_device: int = 0
    dtw_token_timestamps: bool = False
    dtw_aheads_preset: int = 0
    dtw_n_top: int = -1
    dtw_mem_size: int = 1024 * 1024 * 128
    # extension: parameter dtype (None = torch.bfloat16)
    dtype: object = None


def whisper_context_default_params() -> WhisperContextParams:
    return WhisperContextParams()


def whisper_context_default_params_by_ref() -> WhisperContextParams:
    return WhisperContextParams()


def whisper_free_context_params(params) -> None:
    pass


# -- init ---------------------------------------------------------------------

def _device(use_gpu: bool, gpu_device: int) -> str:
    """The torch device whisper.cpp's use_gpu / gpu_device pick."""
    return f"cuda:{gpu_device}" if use_gpu else "cpu"


def _make_context(src, cparams: WhisperContextParams | None,
                  with_state: bool) -> WhisperCompatContext:
    from .io import ggml_whisper
    cparams = cparams or WhisperContextParams()
    dtype = cparams.dtype or torch.bfloat16
    device = _device(cparams.use_gpu, cparams.gpu_device)
    F._resolve_device(device)     # no CUDA: raise before parsing anything
    hparams = ggml_whisper.load_checkpoint(src, load_tensors=False).hparams
    return WhisperCompatContext(
        F.WhisperContext.from_file(src, dtype=dtype, device=device),
        hparams=hparams, with_state=with_state)


def whisper_init_from_file_with_params(path: str, params=None
                                       ) -> WhisperCompatContext:
    return _make_context(path, params, with_state=True)


def whisper_init_from_file_with_params_no_state(path: str, params=None
                                                ) -> WhisperCompatContext:
    return _make_context(path, params, with_state=False)


def whisper_init_from_buffer_with_params(buf: bytes, params=None,
                                         buffer_size: int | None = None
                                         ) -> WhisperCompatContext:
    if buffer_size is not None:
        buf = bytes(buf)[:buffer_size]
    return _make_context(buf, params, with_state=True)


def whisper_init_from_buffer_with_params_no_state(buf: bytes, params=None,
                                                  buffer_size: int | None = None
                                                  ) -> WhisperCompatContext:
    if buffer_size is not None:
        buf = bytes(buf)[:buffer_size]
    return _make_context(buf, params, with_state=False)


def whisper_init_with_params(loader, params=None) -> WhisperCompatContext:
    """Generic-loader init: `loader` is bytes or a readable binary stream
    (the C version takes a read/eof/close vtable)."""
    data = loader if isinstance(loader, (bytes, bytearray)) else loader.read()
    return _make_context(bytes(data), params, with_state=True)


def whisper_init_with_params_no_state(loader, params=None
                                      ) -> WhisperCompatContext:
    data = loader if isinstance(loader, (bytes, bytearray)) else loader.read()
    return _make_context(bytes(data), params, with_state=False)


# deprecated aliases (include/whisper.h:149-170)
def whisper_init_from_file(path: str, dtype=None) -> WhisperCompatContext:
    return _make_context(
        path, WhisperContextParams(dtype=dtype or torch.bfloat16),
        with_state=True)


def whisper_init_from_buffer(buf: bytes, buffer_size: int | None = None
                             ) -> WhisperCompatContext:
    return whisper_init_from_buffer_with_params(buf, None, buffer_size)


def whisper_init(loader) -> WhisperCompatContext:
    return whisper_init_with_params(loader, None)


def whisper_init_from_file_no_state(path: str) -> WhisperCompatContext:
    return whisper_init_from_file_with_params_no_state(path, None)


def whisper_init_from_buffer_no_state(buf: bytes, buffer_size=None
                                      ) -> WhisperCompatContext:
    return whisper_init_from_buffer_with_params_no_state(buf, None,
                                                         buffer_size)


def whisper_init_no_state(loader) -> WhisperCompatContext:
    return whisper_init_with_params_no_state(loader, None)


def whisper_init_state(ctx: WhisperCompatContext) -> WhisperCompatState:
    return WhisperCompatState(ctx)


def whisper_free_state(state: WhisperCompatState) -> None:
    state.mel = state.xk = state.xv = state.kv_k = state.kv_v = None
    state.result = F.TranscribeResult(segments=[])


def whisper_free(ctx: WhisperCompatContext):
    ctx.state = WhisperCompatState(ctx)


def whisper_ctx_init_openvino_encoder_with_state(ctx, state, model_path=None,
                                                 device=None,
                                                 cache_dir=None) -> int:
    """No second vendor runtime (docs/PARITY.md); mirrors the reference
    built without OpenVINO: logs nothing, returns failure."""
    return 1


def whisper_ctx_init_openvino_encoder(ctx, model_path=None, device=None,
                                      cache_dir=None) -> int:
    return 1


# -- params -------------------------------------------------------------------

def whisper_full_default_params(strategy=WHISPER_SAMPLING_GREEDY) -> FullParams:
    return FullParams(strategy=strategy)


def whisper_full_default_params_by_ref(strategy=WHISPER_SAMPLING_GREEDY
                                       ) -> FullParams:
    return FullParams(strategy=strategy)


def whisper_free_params(params) -> None:
    pass


# -- mel / encode / decode (include/whisper.h:276-334) ------------------------

def whisper_pcm_to_mel_with_state(ctx: WhisperCompatContext,
                                  state: WhisperCompatState,
                                  samples: np.ndarray,
                                  n_samples: int | None = None,
                                  n_threads: int = 0) -> int:
    from .audio import mel as mel_mod
    samples = np.asarray(samples, np.float32)
    if n_samples is not None:
        samples = samples[:n_samples]
    state.mel = mel_mod.log_mel_spectrogram(samples, ctx.ctx.filters,
                                            device=ctx.ctx.device)
    return 0


def whisper_pcm_to_mel(ctx, samples, n_samples=None, n_threads=0) -> int:
    return whisper_pcm_to_mel_with_state(ctx, _require_state(ctx), samples,
                                         n_samples, n_threads)


def whisper_set_mel_with_state(ctx: WhisperCompatContext,
                               state: WhisperCompatState,
                               data: np.ndarray, n_len: int,
                               n_mel: int) -> int:
    from .audio import mel as mel_mod
    if n_mel != ctx.ctx.cfg.n_mels:
        return -1
    arr = np.asarray(data, np.float32).reshape(n_mel, n_len).T.copy()
    state.mel = mel_mod.Mel(data=torch.from_numpy(arr).to(ctx.ctx.device),
                            n_len=n_len, n_len_org=n_len)
    return 0


def whisper_set_mel(ctx, data, n_len: int, n_mel: int) -> int:
    return whisper_set_mel_with_state(ctx, _require_state(ctx), data,
                                      n_len, n_mel)


def whisper_n_len_from_state(state: WhisperCompatState) -> int:
    return state.mel.n_len if state.mel is not None else 0


def whisper_n_len(ctx: WhisperCompatContext) -> int:
    return whisper_n_len_from_state(_require_state(ctx))


def whisper_encode_with_state(ctx: WhisperCompatContext,
                              state: WhisperCompatState,
                              offset: int, n_threads: int = 0) -> int:
    if state.mel is None:
        return -1
    _eo, state.xk, state.xv = ctx.ctx.encode_window(state.mel.data, offset, 0)
    return 0


def whisper_encode(ctx, offset: int, n_threads: int = 0) -> int:
    return whisper_encode_with_state(ctx, _require_state(ctx), offset,
                                     n_threads)


def whisper_decode_with_state(ctx: WhisperCompatContext,
                              state: WhisperCompatState,
                              tokens, n_tokens: int | None = None,
                              n_past: int = 0, n_threads: int = 0) -> int:
    """Batched decode of `tokens` at positions n_past.. against the state's
    KV cache; logits for every position land in whisper_get_logits."""
    if state.xk is None:
        return -1
    from .models.whisper import model as M
    toks = list(tokens)[:n_tokens] if n_tokens is not None else list(tokens)
    if not toks:
        return -1
    c = ctx.ctx
    if n_past == 0 or state.kv_k is None:
        state.kv_k, state.kv_v = M.init_kv_cache(c.cfg, 1, dtype=c.dtype,
                                                 device=c.device)
    arr = torch.tensor([toks], dtype=torch.long, device=c.device)
    logits, state.kv_k, state.kv_v = M.decode_impl(
        c.cfg, c.params["decoder"], arr, state.kv_k, state.kv_v, n_past,
        state.xk, state.xv)
    state.logits = logits[0].float().cpu().numpy()
    return 0


def whisper_decode(ctx, tokens, n_tokens=None, n_past=0,
                   n_threads=0) -> int:
    return whisper_decode_with_state(ctx, _require_state(ctx), tokens,
                                     n_tokens, n_past, n_threads)


def whisper_get_logits_from_state(state: WhisperCompatState) -> np.ndarray:
    return state.logits


def whisper_get_logits(ctx: WhisperCompatContext) -> np.ndarray:
    return whisper_get_logits_from_state(_require_state(ctx))


# -- main entry points --------------------------------------------------------

def whisper_full_with_state(ctx: WhisperCompatContext,
                            state: WhisperCompatState, params: FullParams,
                            samples: np.ndarray,
                            n_samples: int | None = None) -> int:
    if n_samples is not None:
        samples = np.asarray(samples, np.float32)[:n_samples]
    state.result = F.whisper_full(ctx.ctx, params, samples)
    return 0


def whisper_full(ctx: WhisperCompatContext, params: FullParams,
                 samples: np.ndarray, n_samples: int | None = None) -> int:
    return whisper_full_with_state(ctx, _require_state(ctx), params,
                                   samples, n_samples)


def whisper_full_parallel(ctx: WhisperCompatContext, params: FullParams,
                          samples: np.ndarray, n_samples: int,
                          n_processors: int) -> int:
    from .parallel.dp import full_parallel
    ctx.result = full_parallel(ctx.ctx, params,
                               np.asarray(samples, np.float32)[:n_samples],
                               n_processors)
    return 0


def whisper_lang_auto_detect_with_state(ctx: WhisperCompatContext,
                                        state: WhisperCompatState,
                                        offset_ms: int, n_threads: int = 0,
                                        lang_probs: np.ndarray | None = None
                                        ) -> int:
    """Uses the state's mel (whisper_pcm_to_mel/set_mel must have run)."""
    if state.mel is None:
        return -6  # WHISPER_ERR_NO_MEL-style failure
    lang_id, probs = F.detect_language(ctx.ctx, state.mel, offset_ms)
    if lang_probs is not None:
        lang_probs[:len(probs)] = probs
    return lang_id


def whisper_lang_auto_detect(ctx: WhisperCompatContext, offset_ms: int,
                             n_threads: int = 0,
                             lang_probs: np.ndarray | None = None,
                             samples: np.ndarray | None = None) -> int:
    from .audio import mel as mel_mod
    state = _require_state(ctx)
    if samples is not None:
        state.mel = mel_mod.log_mel_spectrogram(
            np.asarray(samples, np.float32), ctx.ctx.filters,
            device=ctx.ctx.device)
    return whisper_lang_auto_detect_with_state(ctx, state, offset_ms,
                                               n_threads, lang_probs)


# -- results ------------------------------------------------------------------

def whisper_full_n_segments(ctx: WhisperCompatContext) -> int:
    return len(ctx.result.segments)


def whisper_full_get_segment_text(ctx: WhisperCompatContext, i: int) -> str:
    return ctx.result.segments[i].text


def whisper_full_get_segment_t0(ctx: WhisperCompatContext, i: int) -> int:
    return ctx.result.segments[i].t0


def whisper_full_get_segment_t1(ctx: WhisperCompatContext, i: int) -> int:
    return ctx.result.segments[i].t1


def whisper_full_get_segment_no_speech_prob(ctx, i: int) -> float:
    return ctx.result.segments[i].no_speech_prob


def whisper_full_get_segment_speaker_turn_next(ctx, i: int) -> bool:
    return ctx.result.segments[i].speaker_turn_next


def whisper_full_n_tokens(ctx: WhisperCompatContext, i: int) -> int:
    return len(ctx.result.segments[i].tokens)


def whisper_full_get_token_id(ctx, i: int, j: int) -> int:
    return ctx.result.segments[i].tokens[j].id


def whisper_full_get_token_text(ctx: WhisperCompatContext, i: int, j: int) -> str:
    return ctx.ctx.vocab.token_to_str(ctx.result.segments[i].tokens[j].id)


def whisper_full_get_token_p(ctx, i: int, j: int) -> float:
    return ctx.result.segments[i].tokens[j].p


def whisper_full_get_token_data(ctx, i: int, j: int):
    return ctx.result.segments[i].tokens[j]


def whisper_full_lang_id(ctx: WhisperCompatContext) -> int:
    return ctx.result.lang_id


# -- *_from_state result accessors (include/whisper.h:620-700) ----------------

def whisper_full_n_segments_from_state(state: WhisperCompatState) -> int:
    return len(state.result.segments)


def whisper_full_lang_id_from_state(state: WhisperCompatState) -> int:
    return state.result.lang_id


def whisper_full_get_segment_t0_from_state(state, i: int) -> int:
    return state.result.segments[i].t0


def whisper_full_get_segment_t1_from_state(state, i: int) -> int:
    return state.result.segments[i].t1


def whisper_full_get_segment_speaker_turn_next_from_state(state, i) -> bool:
    return state.result.segments[i].speaker_turn_next


def whisper_full_get_segment_text_from_state(state, i: int) -> str:
    return state.result.segments[i].text


def whisper_full_get_segment_no_speech_prob_from_state(state, i: int) -> float:
    return state.result.segments[i].no_speech_prob


def whisper_full_n_tokens_from_state(state, i: int) -> int:
    return len(state.result.segments[i].tokens)


def whisper_full_get_token_text_from_state(ctx, state, i: int, j: int) -> str:
    return ctx.ctx.vocab.token_to_str(state.result.segments[i].tokens[j].id)


def whisper_full_get_token_id_from_state(state, i: int, j: int) -> int:
    return state.result.segments[i].tokens[j].id


def whisper_full_get_token_data_from_state(state, i: int, j: int):
    return state.result.segments[i].tokens[j]


def whisper_full_get_token_p_from_state(state, i: int, j: int) -> float:
    return state.result.segments[i].tokens[j].p


# -- model info ---------------------------------------------------------------

def whisper_n_vocab(ctx) -> int:
    return ctx.ctx.cfg.n_vocab


def whisper_n_audio_ctx(ctx) -> int:
    return ctx.ctx.cfg.n_audio_ctx


def whisper_n_text_ctx(ctx) -> int:
    return ctx.ctx.cfg.n_text_ctx


def whisper_is_multilingual(ctx) -> bool:
    return ctx.ctx.vocab.is_multilingual


def whisper_model_n_vocab(ctx) -> int:
    return ctx.ctx.cfg.n_vocab


def whisper_model_n_audio_ctx(ctx) -> int:
    return ctx.ctx.cfg.n_audio_ctx


def whisper_model_n_audio_state(ctx) -> int:
    return ctx.ctx.cfg.n_audio_state


def whisper_model_n_audio_head(ctx) -> int:
    return ctx.ctx.cfg.n_audio_head


def whisper_model_n_audio_layer(ctx) -> int:
    return ctx.ctx.cfg.n_audio_layer


def whisper_model_n_text_ctx(ctx) -> int:
    return ctx.ctx.cfg.n_text_ctx


def whisper_model_n_text_state(ctx) -> int:
    return ctx.ctx.cfg.n_text_state


def whisper_model_n_text_head(ctx) -> int:
    return ctx.ctx.cfg.n_text_head


def whisper_model_n_text_layer(ctx) -> int:
    return ctx.ctx.cfg.n_text_layer


def whisper_model_n_mels(ctx) -> int:
    return ctx.ctx.cfg.n_mels


def whisper_model_ftype(ctx) -> int:
    return ctx.hparams.ftype if ctx.hparams is not None else -1


# e_model enum (src/whisper.cpp:409-417)
_MODEL_TYPE_IDS = {"tiny": 1, "base": 2, "small": 3, "medium": 4, "large": 5}


def whisper_model_type(ctx) -> int:
    base = ctx.ctx.model_type.split("-")[0].split(".")[0]
    return _MODEL_TYPE_IDS.get(base, 0)


def whisper_model_type_readable(ctx) -> str:
    return ctx.ctx.model_type


# -- tokens -------------------------------------------------------------------

def whisper_tokenize(ctx, text: str, tokens=None, n_max_tokens=0) -> list[int]:
    return ctx.ctx.vocab.tokenize(text)


def whisper_token_to_str(ctx, token: int) -> str:
    return ctx.ctx.vocab.token_to_str(token)


def whisper_token_eot(ctx) -> int:
    return ctx.ctx.vocab.token_eot


def whisper_token_sot(ctx) -> int:
    return ctx.ctx.vocab.token_sot


def whisper_token_prev(ctx) -> int:
    return ctx.ctx.vocab.token_prev


def whisper_token_solm(ctx) -> int:
    return ctx.ctx.vocab.token_solm


def whisper_token_nosp(ctx) -> int:
    return ctx.ctx.vocab.token_nosp


def whisper_token_not(ctx) -> int:
    return ctx.ctx.vocab.token_not


def whisper_token_beg(ctx) -> int:
    return ctx.ctx.vocab.token_beg


def whisper_token_lang(ctx, lang_id: int) -> int:
    return ctx.ctx.vocab.token_lang(lang_id)


def whisper_token_translate(ctx) -> int:
    return ctx.ctx.vocab.token_translate


def whisper_token_transcribe(ctx) -> int:
    return ctx.ctx.vocab.token_transcribe


# -- languages ----------------------------------------------------------------

def whisper_lang_max_id() -> int:
    return len(T.LANGUAGES) - 1


def whisper_lang_id(lang: str) -> int:
    return T.lang_id(lang)


def whisper_lang_str(lang_id: int) -> str:
    return T.lang_str(lang_id)


def whisper_lang_str_full(lang_id: int) -> str:
    if 0 <= lang_id < len(T.LANGUAGES):
        return T.LANGUAGES[lang_id][1]
    return "??"


# -- misc ---------------------------------------------------------------------

@dataclasses.dataclass
class WhisperTimings:
    """whisper_timings (include/whisper.h:438-447)."""
    sample_ms: float = 0.0
    encode_ms: float = 0.0
    decode_ms: float = 0.0
    batchd_ms: float = 0.0
    prompt_ms: float = 0.0


def whisper_get_timings(ctx: WhisperCompatContext) -> WhisperTimings:
    t = ctx.result.timings
    per = lambda ms, n: ms / n if n else 0.0
    return WhisperTimings(
        sample_ms=per(t.t_sample_ms, t.n_sample),
        encode_ms=per(t.t_encode_ms, t.n_encode),
        decode_ms=per(t.t_decode_ms, t.n_decode),
        batchd_ms=0.0,
        prompt_ms=0.0,
    )


def whisper_version() -> str:
    """Reference API version this surface tracks (CMakeLists.txt:3) plus
    the framework marker of the JAX package, which this port keeps."""
    return "1.8.3-tpu"


def whisper_print_timings(ctx: WhisperCompatContext):
    TM.print_timings(ctx.result)


def whisper_reset_timings(ctx: WhisperCompatContext):
    ctx.result.timings = dataclasses.replace(ctx.result.timings.__class__())


def whisper_print_system_info() -> str:
    return TM.system_info()


def whisper_log_set(callback, user_data=None):
    if callback is None:
        TM.log_set(None)
    else:
        TM.log_set(lambda lvl, msg: callback(lvl, msg, user_data))


# -- VAD C surface (include/whisper.h:640-736) --------------------------------

@dataclasses.dataclass
class WhisperVadContextParams:
    """whisper_vad_context_params (include/whisper.h:652-658)."""
    n_threads: int = 4
    use_gpu: bool = True
    gpu_device: int = 0


class WhisperVadCompatContext:
    """whisper_vad_context: the Silero model plus the rolling prob buffer
    the stateful/stateless detect calls append to."""

    def __init__(self, vad):
        self.vad = vad
        self.probs = np.zeros(0, np.float32)


class WhisperVadSegments:
    def __init__(self, segments):
        self.segments = segments


def whisper_vad_default_context_params() -> WhisperVadContextParams:
    return WhisperVadContextParams()


def whisper_vad_default_params():
    from .decode.params import VadParams
    return VadParams()


def _vad_device(params: WhisperVadContextParams | None) -> str:
    params = params or WhisperVadContextParams()
    return _device(params.use_gpu, params.gpu_device)


def whisper_vad_init_from_file_with_params(path: str, params=None
                                           ) -> WhisperVadCompatContext:
    from .models.silero.vad import SileroVAD
    return WhisperVadCompatContext(
        SileroVAD.from_file(path, device=F._resolve_device(_vad_device(params))))


def whisper_vad_init_with_params(loader, params=None
                                 ) -> WhisperVadCompatContext:
    """`loader` is bytes or a readable binary stream (C model_loader)."""
    import tempfile
    from .models.silero.vad import SileroVAD
    device = F._resolve_device(_vad_device(params))
    data = loader if isinstance(loader, (bytes, bytearray)) else loader.read()
    with tempfile.NamedTemporaryFile(suffix=".bin") as f:
        f.write(bytes(data))
        f.flush()
        return WhisperVadCompatContext(SileroVAD.from_file(f.name, device=device))


def whisper_vad_detect_speech(vctx: WhisperVadCompatContext,
                              samples, n_samples: int | None = None) -> bool:
    samples = np.asarray(samples, np.float32)
    if n_samples is not None:
        samples = samples[:n_samples]
    vctx.probs = vctx.vad.detect_speech(samples, reset=True)
    return True


def whisper_vad_detect_speech_stateful(vctx: WhisperVadCompatContext,
                                       samples,
                                       n_samples: int | None = None) -> bool:
    """Keeps the LSTM h/c across calls and appends to the prob buffer
    (include/whisper.h:698-709 streaming contract)."""
    samples = np.asarray(samples, np.float32)
    if n_samples is not None:
        samples = samples[:n_samples]
    new = vctx.vad.detect_speech(samples, reset=False)
    vctx.probs = np.concatenate([vctx.probs, new])
    return True


def whisper_vad_reset_state(vctx: WhisperVadCompatContext) -> None:
    vctx.vad.reset_state()
    vctx.probs = np.zeros(0, np.float32)


def whisper_vad_n_probs(vctx: WhisperVadCompatContext) -> int:
    return len(vctx.probs)


def whisper_vad_probs(vctx: WhisperVadCompatContext) -> np.ndarray:
    return vctx.probs


def whisper_vad_segments_from_probs(vctx: WhisperVadCompatContext,
                                    params) -> WhisperVadSegments:
    from .vad.segments import segments_from_probs
    return WhisperVadSegments(segments_from_probs(vctx.probs, params))


def whisper_vad_segments_from_samples(vctx: WhisperVadCompatContext, params,
                                      samples,
                                      n_samples: int | None = None
                                      ) -> WhisperVadSegments:
    whisper_vad_detect_speech(vctx, samples, n_samples)
    return whisper_vad_segments_from_probs(vctx, params)


def whisper_vad_segments_n_segments(segments: WhisperVadSegments) -> int:
    return len(segments.segments)


def whisper_vad_segments_get_segment_t0(segments, i: int) -> float:
    return segments.segments[i].start


def whisper_vad_segments_get_segment_t1(segments, i: int) -> float:
    return segments.segments[i].end


def whisper_vad_free_segments(segments: WhisperVadSegments) -> None:
    segments.segments = []


def whisper_vad_free(vctx: WhisperVadCompatContext) -> None:
    vctx.probs = np.zeros(0, np.float32)


# -- bench (include/whisper.h:738-741) ----------------------------------------

def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def whisper_bench_memcpy_str(n_threads: int = 1, device="cuda") -> str:
    """Host<->device copy rate (the analog of the reference's CPU memcpy
    sweep, examples/bench/bench.cpp -w 1): 64 MiB of f32 each way on
    `device` (the card unless the caller passes a context's), synchronized
    before the clock is read."""
    import time
    dev = F._resolve_device(device)
    n = 64 * 1024 * 1024
    src = torch.ones(n // 4, dtype=torch.float32)
    if dev.type == "cuda":
        src = src.pin_memory()
    on_dev = src.to(dev)
    _sync(dev)
    reps = 4
    t0 = time.perf_counter()
    for _ in range(reps):
        src.to(dev, copy=True)
    _sync(dev)
    h2d = n * reps / (time.perf_counter() - t0) / 1e9
    t0 = time.perf_counter()
    for _ in range(reps):
        on_dev.to("cpu", copy=True)
    _sync(dev)
    d2h = n * reps / (time.perf_counter() - t0) / 1e9
    return (f"memcpy: {h2d:7.2f} GB/s (host->device)\n"
            f"memcpy: {d2h:7.2f} GB/s (device->host)\n")


def whisper_bench_memcpy(n_threads: int = 1) -> int:
    print(whisper_bench_memcpy_str(n_threads), end="")
    return 0


def whisper_bench_ggml_mul_mat_str(n_threads: int = 1,
                                   sizes=(512, 1024, 2048, 4096),
                                   reps: int = 4, device="cuda") -> str:
    """Square torch.matmul FLOPS sweep (examples/bench/bench.cpp -w 2
    analog) on `device` (the card unless the caller passes another),
    synchronized before the clock is read."""
    import time
    dev = F._resolve_device(device)
    out = []
    for n in sizes:
        for dt, name in ((torch.float32, "F32"), (torch.bfloat16, "BF16")):
            a = torch.ones((n, n), dtype=dt, device=dev)
            torch.matmul(a, a)
            _sync(dev)
            t0 = time.perf_counter()
            for _ in range(reps):
                r = torch.matmul(a, a)
            _sync(dev)
            dt_s = (time.perf_counter() - t0) / reps
            del r
            out.append(f"{n:5d} x {n:5d}: {name} {2*n**3/dt_s/1e9:10.1f}"
                       " GFLOPS")
    return "\n".join(out) + "\n"


def whisper_bench_ggml_mul_mat(n_threads: int = 1) -> int:
    print(whisper_bench_ggml_mul_mat_str(n_threads), end="")
    return 0
