"""Public API facade of the PyTorch port (port of open_whisper_kit_tpu/
api.py: the Transcriber with batched serving, the SortFormer Diarizer,
word <-> speaker `align` and `words_from_result`). Entry points run on the
card ("cuda") unless the caller asks for the CPU."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from .align import aligner as _aligner
from .align import rttm as _rttm
from .align.aligner import AlignmentOptions, DiarizedTranscription, WordTiming
from .align.rttm import RttmSegment
from .audio import mel as mel_mod
from .audio.wav import load_wav
from .decode import batch as _batch
from .decode import full as _full
from .decode.full import Segment, TokenData, TranscribeResult, WhisperContext
from .decode.params import FullParams, SamplingStrategy, VadParams
from .models.sortformer.streaming import (PRESETS, SortformerDiarizer,
                                          SortformerStream, StreamConfig)
from .parallel import dp as _dp

__all__ = [
    "Transcriber", "Diarizer", "FullParams", "SamplingStrategy", "VadParams",
    "Segment", "TokenData", "TranscribeResult", "WhisperContext", "WordTiming",
    "AlignmentOptions", "DiarizedTranscription", "RttmSegment", "align",
    "load_wav", "words_from_result",
]


class Transcriber:
    """Whisper speech-to-text on one torch device, or on a mesh of them."""

    def __init__(self, model_path: str | Path | None = None,
                 preset: str | None = None,
                 dtype: torch.dtype = torch.bfloat16,
                 decoder_int8: bool = False,
                 device: str | torch.device = "cuda", seed: int = 0, *,
                 encoder_int8: bool = False, mesh=None,
                 draft_model_path: str | Path | None = None,
                 draft_preset: str | None = None):
        """`model_path`: a whisper ggml-bin checkpoint (q8_0/q5_0/q4_0
        weights stay int8 planes). `preset`: random weights of a real
        model's shapes from `seed` (the same weights as the JAX package's
        preset). `decoder_int8`: runtime W8 planes for the vocab
        projection. `encoder_int8`: the W8A8 encoder stack (kernel K6;
        q8_0-class error), for every entry point. Runs on the card unless
        `device` asks for the CPU; raises when CUDA is missing.
        `draft_model_path` / `draft_preset`: a smaller model with the same
        vocabulary, loaded on the same device with the same dtype, for
        speculative greedy decoding (FullParams.speculative = gamma).
        `mesh`: a (dp, tp) mesh (parallel/mesh.py `make_mesh()`, on the
        device type `device` names; every rank of it builds its
        Transcriber and makes the same calls): the weights are split over
        tp, and the batched entry points (transcribe_batch,
        transcribe_batched, full_parallel) share their chunks out over dp
        where dp divides them. The W8A8 encoder and speculative decoding
        stay off on a mesh, as in the JAX package."""
        if model_path is not None:
            self.ctx = WhisperContext.from_file(
                str(model_path), dtype=dtype, decoder_int8=decoder_int8,
                device=device, encoder_int8=encoder_int8, mesh=mesh)
        elif preset is not None:
            self.ctx = WhisperContext.from_preset(
                preset, seed=seed, dtype=dtype, decoder_int8=decoder_int8,
                device=device, encoder_int8=encoder_int8, mesh=mesh)
        else:
            raise ValueError("model_path or preset required")
        if draft_model_path is not None:
            self.ctx.set_draft(WhisperContext.from_file(
                str(draft_model_path), dtype=dtype, device=self.ctx.device))
        elif draft_preset is not None:
            self.ctx.set_draft(WhisperContext.from_preset(
                draft_preset, dtype=dtype, device=self.ctx.device))

    def full(self, params: FullParams, samples: np.ndarray,
             generator: torch.Generator | None = None) -> TranscribeResult:
        """whisper_full: transcribe raw 16 kHz mono f32 samples, greedily
        or, with `FullParams(strategy=SamplingStrategy.BEAM_SEARCH,
        beam_search=BeamSearchParams(beam_size=...))` (FullParams.
        beam_default() is whisper.cpp's beam 5), by beam search; with a
        draft model and `FullParams(speculative=gamma)`, greedily by draft
        proposals and verify passes (the same transcript)."""
        return _full.whisper_full(self.ctx, params, samples, generator)

    def detect_language(self, samples: np.ndarray, offset_ms: int = 0):
        """whisper_lang_auto_detect: (lang_id, probs)."""
        mel = mel_mod.log_mel_spectrogram(np.asarray(samples, np.float32),
                                          self.ctx.filters, device=self.ctx.device)
        return _full.detect_language(self.ctx, mel, offset_ms)

    def tokenize(self, text: str) -> list[int]:
        return self.ctx.vocab.tokenize(text)

    def token_to_str(self, token_id: int) -> str:
        return self.ctx.vocab.token_to_str(token_id)

    def transcribe(self, audio: str | Path | np.ndarray,
                   params: FullParams | None = None,
                   generator: torch.Generator | None = None) -> TranscribeResult:
        """Transcribe a WAV path or 16 kHz mono f32 samples."""
        if isinstance(audio, (str, Path)):
            audio = load_wav(audio)
        return self.full(params or FullParams(print_progress=False), audio,
                         generator)

    def transcribe_paths(self, paths: list[str | Path],
                         params: FullParams | None = None,
                         batched: bool = False) -> list[TranscribeResult]:
        """Transcribe several files; `batched=True` decodes all files'
        windows in lockstep on the device (transcribe_batch)."""
        if batched:
            return self.transcribe_batch(list(paths), params)
        return [self.transcribe(p, params) for p in paths]

    def transcribe_batch(self, audios: list, params: FullParams | None = None
                         ) -> list[TranscribeResult]:
        """Lockstep multi-file transcription: every file's windows decode
        together, the B files' encoder passes as one batch and one decoder
        step for all B per token (kernel K8 with `megakernel` True, "int8"
        or "int4"; with `cross_kv_int8`, int8 cross-KV planes read by
        kernel K9b instead). Greedy-t0 serving path with per-file fallback to
        whisper_full where the quality gates trip; params outside that
        envelope run the files one by one through whisper_full."""
        p = params or FullParams(print_progress=False)
        loaded = [load_wav(a) if isinstance(a, (str, Path))
                  else np.asarray(a, np.float32) for a in audios]
        if len(loaded) > 1 and _dp._batch_route_eligible(self.ctx, p):
            segs, tms = _batch.transcribe_chunks_with_timings(self.ctx, p, loaded)
            return [TranscribeResult(segments=s, timings=t) for s, t in zip(segs, tms)]
        return [self.full(p, a) for a in loaded]

    def transcribe_batched(self, audio: str | Path | np.ndarray,
                           params: FullParams | None = None,
                           n_chunks: int = 8) -> TranscribeResult:
        """Serving-throughput mode: decode n_chunks independent chunks of one
        recording in lockstep on the device (decode/batch.py)."""
        if isinstance(audio, (str, Path)):
            audio = load_wav(audio)
        return _batch.transcribe_batched(self.ctx, params or FullParams(print_progress=False),
                                         audio, n_chunks)

    def full_parallel(self, params: FullParams, samples: np.ndarray,
                      n_processors: int) -> TranscribeResult:
        """whisper_full_parallel semantics (per-chunk mel, merged segments)."""
        return _dp.full_parallel(self.ctx, params, samples, n_processors)

    @property
    def model_type(self) -> str:
        return self.ctx.model_type

    @property
    def is_multilingual(self) -> bool:
        return self.ctx.vocab.is_multilingual


class Diarizer:
    """SortFormer speaker diarization (SortFormerContext analog) on one
    torch device.

    frame duration 0.08 s, max 4 speakers
    (Sources/OpenWhisperKit/SortFormerContext.swift:20-30).
    """

    FRAME_DURATION = 0.08
    MAX_SPEAKERS = 4

    def __init__(self, model_path: str | Path | None = None,
                 cfg=None, params=None, dtype: torch.dtype = torch.float32,
                 device: str | torch.device = "cuda"):
        """`model_path`: a SortFormer GGUF. Or `cfg` and `params` (the
        model.py dict of tensors, moved to `device`). Runs on the card
        unless `device` asks for the CPU; raises when CUDA is missing."""
        dev = _full._resolve_device(device)
        if model_path is not None:
            self.engine = SortformerDiarizer.from_file(str(model_path), dtype=dtype,
                                                       device=dev)
        elif cfg is not None and params is not None:
            self.engine = SortformerDiarizer(cfg, _full._to_device(params, dev))
        else:
            raise ValueError("model_path or (cfg, params) required")
        self.device = dev

    def _auto_device_state(self, device_state: bool | None) -> bool:
        """Default the device AOSC loop (one read per file) on for the card,
        the host loop on the CPU."""
        if device_state is not None:
            return device_state
        return self.device.type != "cpu"

    def diarize(self, audio: str | Path | np.ndarray,
                stream_config: StreamConfig | str | None = None,
                threshold: float = 0.5, median_win: int = 11,
                file_id: str | None = None,
                device_state: bool | None = None):
        """-> (probs (T,4), rttm segments)."""
        if isinstance(audio, (str, Path)):
            if file_id is None:
                file_id = Path(audio).stem
            audio = load_wav(audio)
        if isinstance(stream_config, str):
            stream_config = PRESETS[stream_config]
        probs = self.engine.diarize(
            audio, stream_config,
            device_state=self._auto_device_state(device_state))
        segments = _rttm.probs_to_segments(probs, threshold, median_win,
                                           file_id or "unknown")
        return probs, segments

    def diarize_batch(self, audios: list, stream_config=None,
                      threshold: float = 0.5, median_win: int = 11,
                      file_ids: list[str] | None = None,
                      device_state: bool | None = None):
        """Lockstep multi-file diarization -> list of (probs, segments)."""
        loaded = []
        ids = []
        for i, a in enumerate(audios):
            if isinstance(a, (str, Path)):
                ids.append(Path(a).stem)
                loaded.append(load_wav(a))
            else:
                ids.append(file_ids[i] if file_ids else f"file_{i}")
                loaded.append(np.asarray(a, np.float32))
        if isinstance(stream_config, str):
            stream_config = PRESETS[stream_config]
        all_probs = self.engine.diarize_batch(
            loaded, stream_config,
            device_state=self._auto_device_state(device_state))
        return [(p, _rttm.probs_to_segments(p, threshold, median_win, fid))
                for p, fid in zip(all_probs, ids)]

    def diarize_to_rttm(self, audio: str | Path | np.ndarray, **kw) -> str:
        _, segments = self.diarize(audio, **kw)
        return _rttm.to_rttm(segments)

    def stream(self, preset: str | StreamConfig = "low_latency",
               device_state: bool | None = None) -> SortformerStream:
        """True streaming session (sortformer_stream_* analog).

        `device_state=None` keeps the AOSC state on the card (one read per
        chunk: its predictions) and on the host on the CPU."""
        return SortformerStream(self.engine, preset,
                                device_state=self._auto_device_state(device_state))


def align(words: list[WordTiming], segments: list[RttmSegment],
          options: AlignmentOptions | None = None) -> DiarizedTranscription:
    """Word <-> speaker alignment (DiarizationAligner.align)."""
    return _aligner.align(words, segments, options)


def words_from_result(result: TranscribeResult, vocab=None,
                      ctx: WhisperContext | None = None) -> list[WordTiming]:
    """Token-level timestamps -> WordTiming list for word alignment.

    Groups tokens into words at leading-space boundaries
    (the Swift SDK's word extraction, WhisperContext.swift:110-160);
    timestamps are centiseconds -> seconds."""
    if vocab is None and ctx is not None:
        vocab = ctx.vocab
    words: list[WordTiming] = []
    for seg in result.segments:
        cur_text = ""
        cur_t0 = seg.t0
        cur_t1 = seg.t0
        cur_p = []
        for tk in seg.tokens:
            if vocab is not None and tk.id >= vocab.token_eot:
                continue
            s = vocab.token_to_str(tk.id) if vocab is not None else ""
            if s.startswith(" ") and cur_text:
                words.append(WordTiming(cur_text.strip(), cur_t0 / 100.0,
                                        cur_t1 / 100.0,
                                        float(np.mean(cur_p)) if cur_p else 1.0))
                cur_text = ""
                cur_p = []
            if not cur_p and tk.t0 >= 0:
                cur_t0 = tk.t0
            cur_text += s
            if tk.t1 >= 0:
                cur_t1 = tk.t1
            cur_p.append(tk.p)
        if cur_text.strip():
            words.append(WordTiming(cur_text.strip(), cur_t0 / 100.0,
                                    cur_t1 / 100.0,
                                    float(np.mean(cur_p)) if cur_p else 1.0))
    return words
