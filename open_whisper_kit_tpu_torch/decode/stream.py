# Source: open_whisper_kit_tpu/decode/stream.py, copied as it stands (pure Python, numpy and the port's decode/full.py).
"""Real-time sliding-window streaming transcription.

Library port of the reference `whisper-stream` loop
(examples/stream/stream.cpp): step/length/keep sliding window with context
carry in step mode, or the energy/high-pass `vad_simple` gate
(examples/common.cpp:578-645) in VAD mode. The audio source is decoupled
(feed() takes arbitrary sample blocks) so the same engine drives a mic, a
file replayed in real time, or a network stream.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import full as F
from .params import BeamSearchParams, FullParams, SamplingStrategy

SAMPLE_RATE = 16000


def high_pass_filter(data: np.ndarray, cutoff: float,
                     sample_rate: float = SAMPLE_RATE) -> np.ndarray:
    """First-order high-pass (examples/common.cpp:598-609)."""
    rc = 1.0 / (2.0 * np.pi * cutoff)
    dt = 1.0 / sample_rate
    alpha = dt / (rc + dt)
    out = data.astype(np.float32).copy()
    y = out[0]
    # note: the reference filters in place, so data[i-1] reads the already
    # filtered value — reproduced here for output parity
    for i in range(1, len(out)):
        y = alpha * (y + out[i] - out[i - 1])
        out[i] = y
    return out


def vad_simple(pcm: np.ndarray, last_ms: int, vad_thold: float,
               freq_thold: float, sample_rate: int = SAMPLE_RATE) -> bool:
    """True when the last `last_ms` are quiet relative to the whole buffer
    (speech just ended; examples/common.cpp:610-645)."""
    n = len(pcm)
    n_last = sample_rate * last_ms // 1000
    if n_last >= n:
        return False
    if freq_thold > 0:
        pcm = high_pass_filter(pcm.astype(np.float32), freq_thold, sample_rate)
    energy_all = float(np.abs(pcm).mean())
    energy_last = float(np.abs(pcm[n - n_last:]).mean())
    return energy_last <= vad_thold * energy_all


@dataclasses.dataclass
class StreamParams:
    """Mirror of the stream example's whisper_params (stream.cpp:18-44)."""
    step_ms: int = 3000
    length_ms: int = 10000
    keep_ms: int = 200
    max_tokens: int = 32
    audio_ctx: int = 0
    beam_size: int = -1
    vad_thold: float = 0.6
    freq_thold: float = 100.0
    translate: bool = False
    no_fallback: bool = False
    print_special: bool = False
    no_context: bool = True
    no_timestamps: bool = False
    tinydiarize: bool = False
    language: str = "en"


@dataclasses.dataclass
class StreamEvent:
    text: str
    t0: int                 # centiseconds within the window
    t1: int
    final: bool             # True when the line is committed
    speaker_turn_next: bool = False
    n_iter: int = 0


class StreamingTranscriber:
    """Feed PCM, get incremental transcription events."""

    def __init__(self, ctx: F.WhisperContext, params: StreamParams | None = None):
        self.ctx = ctx
        self.p = params or StreamParams()
        p = self.p
        self.use_vad = p.step_ms <= 0
        self.keep_ms = min(p.keep_ms, p.step_ms) if not self.use_vad else p.keep_ms
        self.n_samples_step = SAMPLE_RATE * max(p.step_ms, 0) // 1000
        self.n_samples_len = SAMPLE_RATE * p.length_ms // 1000
        self.n_samples_keep = SAMPLE_RATE * self.keep_ms // 1000
        self.n_new_line = (max(1, p.length_ms // p.step_ms - 1)
                           if not self.use_vad and not p.no_timestamps else 1)
        self._buf = np.zeros(0, np.float32)
        self._old = np.zeros(0, np.float32)
        self._prompt_tokens: list[int] = []
        self.n_iter = 0

    def _full_params(self) -> FullParams:
        p = self.p
        fp = FullParams(
            strategy=(SamplingStrategy.BEAM_SEARCH if p.beam_size > 1
                      else SamplingStrategy.GREEDY),
            print_progress=False,
            print_special=p.print_special,
            print_timestamps=not p.no_timestamps,
            translate=p.translate,
            single_segment=not self.use_vad,
            max_tokens=p.max_tokens,
            language=p.language,
            audio_ctx=p.audio_ctx,
            tdrz_enable=p.tinydiarize,
            temperature_inc=0.0 if p.no_fallback else 0.2,
        )
        fp.beam_search = BeamSearchParams(beam_size=p.beam_size)
        if not p.no_context and self._prompt_tokens:
            fp.prompt_tokens = list(self._prompt_tokens)
        return fp

    def feed(self, samples: np.ndarray) -> list[StreamEvent]:
        """Append PCM; returns any transcription events produced."""
        self._buf = np.concatenate(
            [self._buf, np.asarray(samples, np.float32)])
        events: list[StreamEvent] = []
        if self.use_vad:
            events.extend(self._feed_vad())
        else:
            while len(self._buf) >= self.n_samples_step:
                events.extend(self._step())
        return events

    def _step(self) -> list[StreamEvent]:
        new = self._buf[:self.n_samples_step]
        self._buf = self._buf[self.n_samples_step:]

        n_take = min(len(self._old),
                     max(0, self.n_samples_keep + self.n_samples_len - len(new)))
        window = np.concatenate([self._old[len(self._old) - n_take:], new])

        res = F.whisper_full(self.ctx, self._full_params(), window)

        self.n_iter += 1
        commit = (self.n_iter % self.n_new_line) == 0

        events = [StreamEvent(s.text, s.t0, s.t1, final=commit,
                              speaker_turn_next=s.speaker_turn_next,
                              n_iter=self.n_iter)
                  for s in res.segments]

        if commit:
            self._old = window[len(window) - self.n_samples_keep:].copy() \
                if self.n_samples_keep > 0 else np.zeros(0, np.float32)
            if not self.p.no_context:
                self._prompt_tokens = [t.id for s in res.segments
                                       for t in s.tokens]
        else:
            self._old = window
        return events

    def flush(self) -> list[StreamEvent]:
        """Decode whatever is buffered as one FINAL window and reset the
        sliding state (end-of-stream; the server's /stream/finish and the
        reference addon's session close)."""
        if self.use_vad:
            window = self._buf[-self.n_samples_len:]
            self._buf = np.zeros(0, np.float32)
            if len(window) < SAMPLE_RATE // 2:
                return []
        else:
            n_take = min(len(self._old),
                         max(0, self.n_samples_keep + self.n_samples_len
                             - len(self._buf)))
            window = np.concatenate(
                [self._old[len(self._old) - n_take:], self._buf])
            self._buf = np.zeros(0, np.float32)
            self._old = np.zeros(0, np.float32)
            if len(window) < SAMPLE_RATE // 10:
                return []
        res = F.whisper_full(self.ctx, self._full_params(), window)
        self.n_iter += 1
        return [StreamEvent(s.text, s.t0, s.t1, final=True,
                            speaker_turn_next=s.speaker_turn_next,
                            n_iter=self.n_iter)
                for s in res.segments]

    def _feed_vad(self) -> list[StreamEvent]:
        probe_n = 2 * SAMPLE_RATE
        if len(self._buf) < probe_n:
            return []
        probe = self._buf[-probe_n:]
        if not vad_simple(probe, 1000, self.p.vad_thold, self.p.freq_thold):
            # still talking; bound the buffer to length_ms + probe
            max_keep = self.n_samples_len + probe_n
            if len(self._buf) > max_keep:
                self._buf = self._buf[-max_keep:]
            return []
        window = self._buf[-self.n_samples_len:]
        self._buf = np.zeros(0, np.float32)
        res = F.whisper_full(self.ctx, self._full_params(), window)
        self.n_iter += 1
        return [StreamEvent(s.text, s.t0, s.t1, final=True,
                            speaker_turn_next=s.speaker_turn_next,
                            n_iter=self.n_iter)
                for s in res.segments]
